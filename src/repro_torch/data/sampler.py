"""CSR neighbor sampler for minibatch GNN training (GraphSAGE-style fixed
fanout, e.g. 15-10): the JAX package's `repro.data.sampler`. Host-side
numpy (the sampler is data-pipeline work), so the same np.random.Generator
calls give the same subgraph; emits padded, static-shape subgraph batches
(the `minibatch_lg` cell's shapes). The batches carry no positions.
"""

import dataclasses

import numpy as np


def _stable_argsort_ids(ids):
    """np.argsort(ids, kind="stable") for non-negative integer ids, by LSD
    radix passes over 16-bit digits (numpy's stable sort of uint16 keys
    is a radix sort; of int32 keys a merge sort, 3x slower at 1e8)."""
    ids = np.asarray(ids)
    if ids.size == 0 or ids.min() < 0:
        return np.argsort(ids, kind="stable")
    top = int(ids.max())
    order = np.argsort((ids & 0xFFFF).astype(np.uint16), kind="stable")
    shift = 16
    while top >> shift:
        digit = ((ids[order] >> shift) & 0xFFFF).astype(np.uint16)
        order = order[np.argsort(digit, kind="stable")]
        shift += 16
    return order


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray    # (N+1,)
    indices: np.ndarray   # (E,)
    n_nodes: int

    @staticmethod
    def from_edges(src, dst, n_nodes):
        order = _stable_argsort_ids(src)
        src_s, dst_s = src[order], dst[order]
        counts = np.bincount(src_s, minlength=n_nodes)
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(indptr, dst_s.astype(np.int32), n_nodes)

    def degree(self, u):
        return self.indptr[u + 1] - self.indptr[u]

    def neighbors(self, u):
        return self.indices[self.indptr[u]:self.indptr[u + 1]]


def sample_fanout(graph: CSRGraph, seed_nodes, fanout, rng):
    """Layer-wise fanout sampling. Returns (nodes, edge_src, edge_dst) where
    edge endpoints index into `nodes` (local ids); nodes[0:len(seeds)] are
    the seeds. Sampling WITH replacement when degree < fanout (standard)."""
    nodes = list(seed_nodes)
    local = {int(n): i for i, n in enumerate(seed_nodes)}
    esrc, edst = [], []
    frontier = list(seed_nodes)
    for f in fanout:
        nxt = []
        for u in frontier:
            nbrs = graph.neighbors(int(u))
            if len(nbrs) == 0:
                continue
            pick = rng.choice(nbrs, f, replace=len(nbrs) < f)
            for v in pick:
                v = int(v)
                if v not in local:
                    local[v] = len(nodes)
                    nodes.append(v)
                    nxt.append(v)
                # message flows neighbor -> center
                esrc.append(local[v])
                edst.append(local[int(u)])
        frontier = nxt
    return (np.asarray(nodes, np.int32), np.asarray(esrc, np.int32),
            np.asarray(edst, np.int32))


def padded_batch(graph, feats, seed_nodes, fanout, rng, *, max_nodes,
                 max_edges, targets=None):
    """Sample + pad to static shapes for the train step.

    Returns a dict matching models/nequip.py's batch contract: target node i
    maps to graph_id i; non-targets go to the ignore bucket (n_targets)."""
    nodes, esrc, edst = sample_fanout(graph, seed_nodes, fanout, rng)
    n, e = len(nodes), len(esrc)
    if n > max_nodes or e > max_edges:
        raise ValueError(f"sample exceeded pad budget: {n}/{max_nodes} nodes "
                         f"{e}/{max_edges} edges")
    nt = len(seed_nodes)
    node_pad = np.zeros(max_nodes, np.int32)
    node_pad[:n] = nodes
    graph_id = np.full(max_nodes, nt, np.int32)
    graph_id[:nt] = np.arange(nt)
    batch = {
        "node_feat": feats[node_pad].astype(np.float32),
        "edge_src": np.pad(esrc, (0, max_edges - e)),
        "edge_dst": np.pad(edst, (0, max_edges - e)),
        "edge_mask": np.pad(np.ones(e, np.float32), (0, max_edges - e)),
        "graph_id": graph_id,
        "energy_target": np.zeros(nt + 1, np.float32),
        "energy_weight": np.concatenate(
            [np.ones(nt, np.float32), np.zeros(1, np.float32)]),
        "node_mask": np.concatenate(
            [np.ones(n, np.float32), np.zeros(max_nodes - n, np.float32)]),
    }
    if targets is not None:
        batch["energy_target"][:nt] = targets[seed_nodes]
    return batch
