"""Assigned input-shape sets, one per architecture family (the JAX
package's `repro.configs.shapes`, the same data).

Every (arch x shape) pair is a dry-run cell. `mode` selects which step
runs: train_step / prefill_step / decode_step / serve_step.
"""

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    mode: str                      # train | prefill | decode | serve | retrieval
    # lm
    seq_len: int = 0
    global_batch: int = 0
    # gnn
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple = ()
    n_graphs: int = 0
    # recsys
    batch: int = 0
    n_candidates: int = 0


LM_SHAPES = {
    "train_4k":    ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    "decode_32k":  ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
    "long_500k":   ShapeSpec("long_500k", "decode", seq_len=524288, global_batch=1),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "train",
                               n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg":  ShapeSpec("minibatch_lg", "train",
                               n_nodes=232965, n_edges=114615892,
                               batch_nodes=1024, fanout=(15, 10), d_feat=602),
    "ogb_products":  ShapeSpec("ogb_products", "train",
                               n_nodes=2449029, n_edges=61859140, d_feat=100),
    "molecule":      ShapeSpec("molecule", "train",
                               n_nodes=30, n_edges=64, n_graphs=128),
}

RECSYS_SHAPES = {
    "train_batch":    ShapeSpec("train_batch", "train", batch=65536),
    "serve_p99":      ShapeSpec("serve_p99", "serve", batch=512),
    "serve_bulk":     ShapeSpec("serve_bulk", "serve", batch=262144),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                batch=1, n_candidates=1_000_000),
}

# the paper's own retrieval system (extra, beyond the 40 assigned cells)
RETRIEVAL_SHAPES = {
    "serve_256": ShapeSpec("serve_256", "retrieval", batch=256),
}

FAMILY_SHAPES = {
    "lm": LM_SHAPES,
    "gnn": GNN_SHAPES,
    "recsys": RECSYS_SHAPES,
    "retrieval": RETRIEVAL_SHAPES,
}


def shapes_for(family: str):
    return FAMILY_SHAPES[family]


def cell_is_skipped(arch_cfg, shape: ShapeSpec) -> Optional[str]:
    """A skip-reason string if this (arch, shape) cell is skipped, else
    None. long_500k needs sub-quadratic attention: it runs only for LM
    archs with a bounded window (mixtral's SWA). The reason is the JAX
    package's string, word for word."""
    if shape.name == "long_500k" and getattr(arch_cfg, "family", "") == "lm":
        if getattr(arch_cfg, "sliding_window", None) is None:
            return ("SKIP(full-attention): 524288-token KV with pure full "
                    "attention is excluded per assignment; see DESIGN.md §6")
    return None
