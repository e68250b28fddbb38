"""Dry-run cell builders: for every (arch x shape) the step function, the
global shape, dtype and placement of every argument, the rules and the
meta, on a production mesh; the JAX package's `repro.launch.specs`.

A Cell's `args` are meta tensors of the GLOBAL shapes (the reference's
ShapeDtypeStructs: no storage) and `in_shardings` the NamedShardings
that place them (the reference's). The dry run materializes each
argument as a meta tensor of its sharding's `local_shape` and runs `fn`
on this rank's slices.

Every cell counts the config as the reference's dry run does, its
defaults included: mixtral-8x7b's and arctic-480b's MoE by "sort"
(`moe_ffn_sort_mesh`, the global dispatch) and NequIP's messages by
"pjit" (`make_train_step` on this rank's edge and node slices, the
global function over edge shards, `models/nequip.py`). The caller's
overrides (the CLI's `--set`, recorded under meta["overrides"]) select
the shard_map variants: `{"moe_impl": "tp_shard_map"}` (or
"ep_shard_map") and `{"msg_impl": "owner_shard_map"}`. The cells that the
reference leaves to its partitioner keep every tensor whole inside the
step: NequIP "pjit" gathers its node arrays and all-reduces each
layer's whole (N, C, 9) aggregate, and recsys `retrieval_cand` and CluSD
`impl="pjit"` gather their sharded operands with
`collectives.gather_replicated` and run the port's one-rank function;
the default CluSD cell (`impl="shard_map"`) runs
`core.distributed.make_serve_step`.
"""

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.common import tree as tu
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec, cell_is_skipped
from repro_torch.models import collectives as coll
from repro_torch.models import nequip as nq
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf
from repro_torch.models.sharding import (NamedSharding, named_sharding,
                                         rules_ctx, spec_axes)

@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    rules: dict
    meta: dict
    cfg: Any = None


def _pad_to(x, m):
    return ((x + m - 1) // m) * m


def _sds(shape, dtype):
    return torch.empty(tuple(shape), dtype=getattr(torch, str(dtype)),
                       device="meta")


def _repl(mesh):
    return NamedSharding(mesh, ())


def _opt_abstract(params_abs, opt_dtype):
    mk = lambda l: _sds(l.shape, opt_dtype if l.is_floating_point()
                        else str(l.dtype).replace("torch.", ""))
    return {"mu": tu.tree_map(mk, params_abs),
            "nu": tu.tree_map(mk, params_abs),
            "count": _sds((), "int32")}


def _opt_shardings(param_sh, mesh):
    return {"mu": param_sh, "nu": param_sh, "count": _repl(mesh)}


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_cell(arch, cfg, shape, mesh, multi_pod):
    B, S = shape.global_batch, shape.seq_len
    rules = {}
    if shape.mode in ("decode", "prefill"):
        rules["seq_kv"] = ("model",)  # flash-decode / cache-emit seq shard
    if B == 1:
        rules["batch"] = None  # long_500k: batch axis unshardable
    with rules_ctx(rules, mesh=None, pod_dp=multi_pod):
        params_abs = tf.abstract_params(cfg)
        params_sh = tf.param_shardings(cfg, mesh)
        batch_sh = named_sharding(mesh, "batch", None)
        if shape.mode == "train":
            fn = tf.make_train_step(cfg)
            opt_abs = _opt_abstract(params_abs, cfg.opt_state_dtype)
            args = (params_abs, opt_abs,
                    {"tokens": _sds((B, S), "int32"),
                     "labels": _sds((B, S), "int32")})
            shardings = (params_sh, _opt_shardings(params_sh, mesh),
                         {"tokens": batch_sh, "labels": batch_sh})
        elif shape.mode == "prefill":
            fn = tf.make_prefill_step(cfg)
            args = (params_abs, _sds((B, S), "int32"))
            shardings = (params_sh, batch_sh)
        else:  # decode
            step = tf.make_decode_step(cfg)

            def fn(params, cache, tokens, pos):
                # the write position: the last slot (a meta tensor holds
                # no value; the step's work does not depend on it)
                return step(params, cache, tokens, S - 1)
            cache_abs = tf.abstract_cache(cfg, B, S)
            cache_sh = tf.cache_shardings(cfg, mesh, B, S)
            args = (params_abs, cache_abs, _sds((B, 1), "int32"),
                    _sds((), "int32"))
            shardings = (params_sh, cache_sh, batch_sh, _repl(mesh))
    return fn, args, shardings, rules


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_sampled_sizes(shape):
    """Padded (n_nodes, n_edges) of the fanout-sampled subgraph."""
    n, nodes, edges = shape.batch_nodes, shape.batch_nodes, 0
    for f in shape.fanout:
        edges += n * f
        n = n * f
        nodes += n
    return nodes, edges


def _gnn_cell(arch, cfg, shape, mesh, multi_pod):
    dt = "float32"
    rules = {}
    if shape.name == "molecule":
        G = shape.n_graphs
        N = shape.n_nodes * G
        E = _pad_to(shape.n_edges * G, 512)
        d_feat = 0
    elif shape.batch_nodes:  # minibatch_lg — shapes from the neighbor sampler
        N, E = _gnn_sampled_sizes(shape)
        N, E = _pad_to(N, 512), _pad_to(E, 512)
        G = shape.batch_nodes + 1          # +1 ignore bucket for non-targets
        d_feat = shape.d_feat
        rules["nodes"] = ("data",)
    else:
        N = _pad_to(shape.n_nodes, 512) if shape.n_nodes > 100_000 else shape.n_nodes
        E = _pad_to(shape.n_edges, 512)
        G = 1
        d_feat = shape.d_feat
        if shape.n_nodes > 100_000:
            rules["nodes"] = ("data",)

    owner_sharded = getattr(cfg, "msg_impl", "pjit") == "owner_shard_map"
    with rules_ctx(rules, mesh=None, pod_dp=multi_pod):
        params_abs = nq.abstract_params(cfg, d_feat)
        params_sh = nq.param_shardings(cfg, mesh, d_feat)
        node_sh = named_sharding(mesh, "nodes", None)
        node1_sh = named_sharding(mesh, "nodes")
        edge_sh = named_sharding(mesh, "edges")
        batch = {
            "positions": _sds((N, 3), dt),
            "graph_id": _sds((N,), "int32"),
            "energy_target": _sds((G,), dt),
        }
        batch_sh = {
            "positions": node_sh,
            "graph_id": node1_sh,
            "energy_target": _repl(mesh),
        }
        if owner_sharded:
            # edges pre-partitioned by dst owner; 10% imbalance pad
            n_shards = mesh.size
            e_loc = max(8, ((int(1.1 * E / n_shards) + 7) // 8) * 8)
            shard_spec = NamedSharding(mesh, (tuple(mesh.axis_names), None))
            for k, dtp in (("edge_src_sharded", "int32"),
                           ("edge_dst_sharded", "int32"),
                           ("edge_mask_sharded", "float32")):
                batch[k] = _sds((n_shards, e_loc), dtp)
                batch_sh[k] = shard_spec
        else:
            batch.update({
                "edge_src": _sds((E,), "int32"),
                "edge_dst": _sds((E,), "int32"),
                "edge_mask": _sds((E,), dt),
            })
            batch_sh.update({"edge_src": edge_sh, "edge_dst": edge_sh,
                             "edge_mask": edge_sh})
        if d_feat:
            batch["node_feat"] = _sds((N, d_feat), dt)
            batch_sh["node_feat"] = node_sh
        else:
            batch["species"] = _sds((N,), "int32")
            batch_sh["species"] = node1_sh
        if shape.batch_nodes:
            batch["energy_weight"] = _sds((G,), dt)
            batch_sh["energy_weight"] = _repl(mesh)

        if owner_sharded:
            fn = _owner_sharded_step(cfg, mesh, batch_sh)
        else:   # "pjit": the global step on this rank's slices
            fn = nq.make_train_step(cfg)
        opt_abs = _opt_abstract(params_abs, "float32")
        args = (params_abs, opt_abs, batch)
        shardings = (params_sh, _opt_shardings(params_sh, mesh), batch_sh)
    return fn, args, shardings, rules


def _owner_sharded_step(cfg, mesh, batch_sh):
    """The owner-sharded train step on this rank's slices of the cell's
    batch: node arrays split over "nodes" gathered whole (the
    reference's shard_map takes them replicated), and this rank's row of
    each owner-sharded edge array stood at its row index (a zero-stride
    view) for the step's whole-array layout."""
    from repro_torch.models import nequip_sharded as nqs
    axes = tuple(mesh.axis_names)
    step = nqs.make_train_step_sharded(cfg, mesh, axes)

    def fn(params, opt_state, batch):
        b = {}
        for k, v in batch.items():
            s = batch_sh[k]
            if k.endswith("_sharded"):
                b[k] = v.expand(mesh.size, v.shape[1])
            elif s.spec and spec_axes(s.spec[0]):
                b[k] = coll.gather_replicated(v, mesh, spec_axes(s.spec[0]),
                                              0)
            else:
                b[k] = v
        return step(params, opt_state, b)
    return fn


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------

def _recsys_batch(cfg, B, with_label=True):
    batch = {"sparse": _sds((B, len(cfg.table_sizes)), "int32")}
    if cfg.kind == "dlrm":
        batch["dense"] = _sds((B, cfg.n_dense), "float32")
    if cfg.kind == "din":
        batch["hist_item"] = _sds((B, cfg.seq_len), "int32")
        batch["hist_cate"] = _sds((B, cfg.seq_len), "int32")
        batch["hist_mask"] = _sds((B, cfg.seq_len), "float32")
    if with_label:
        batch["label"] = _sds((B,), "int32")
    return batch


def _recsys_batch_shardings(batch, mesh):
    b2 = named_sharding(mesh, "batch", None)
    b1 = named_sharding(mesh, "batch")
    return {k: (b1 if v.dim() == 1 else b2) for k, v in batch.items()}


def _recsys_cell(arch, cfg, shape, mesh, multi_pod):
    from repro_torch.core.retrieval import CandidateIndexSpec
    rules = {}
    with rules_ctx(rules, mesh=None, pod_dp=multi_pod):
        params_abs = rs.abstract_params(cfg)
        params_sh = rs.param_shardings(cfg, mesh)
        if shape.mode in ("train", "serve"):
            B = shape.batch
            batch = _recsys_batch(cfg, B, with_label=shape.mode == "train")
            batch_sh = _recsys_batch_shardings(batch, mesh)
            if shape.mode == "train":
                fn = rs.make_train_step(cfg)
                opt_abs = _opt_abstract(params_abs, "float32")
                args = (params_abs, opt_abs, batch)
                shardings = (params_sh, _opt_shardings(params_sh, mesh),
                             batch_sh)
            else:
                fn = rs.make_serve_step(cfg)
                args = (params_abs, batch)
                shardings = (params_sh, batch_sh)
        else:  # retrieval_cand: CluSD-accelerated scorer
            spec_ = CandidateIndexSpec(
                n_candidates=shape.n_candidates, n_clusters=4096, cap=256,
                local_topk=getattr(cfg, "retrieval_local_topk", False))
            N, cap, d = spec_.n_clusters, spec_.cap, cfg.embed_dim
            rules["batch"] = None  # single query
            batch = _recsys_batch(cfg, 1, with_label=False)
            batch_sh = tu.tree_map(lambda _: _repl(mesh), batch)
            n_item = 2
            nb = min(64, N - 1)
            feat = 1 + spec_.u_bins + 2 * spec_.v_bins
            lstm_abs = _lstm_abstract(feat, 32)
            repl = _repl(mesh)
            cand_sh = named_sharding(mesh, "candidates", None)
            blocks_sh = named_sharding(mesh, "clusters", None, None)
            args = (params_abs, batch, _sds((N * cap, n_item), "int32"),
                    _sds((N, cap, d), "float32"), _sds((N, d), "float32"),
                    lstm_abs, _sds((N, nb), "int32"),
                    _sds((N, nb), "float32"))
            shardings = (params_sh, batch_sh, cand_sh, blocks_sh, repl,
                         tu.tree_map(lambda _: repl, lstm_abs), repl, repl)
            fn = _retrieval_cand_fn(cfg, spec_, mesh, shardings)
    return fn, args, shardings, rules


def _lstm_abstract(feat_dim, hidden):
    H = hidden
    return {"wx": _sds((feat_dim, 4 * H), "float32"),
            "wh": _sds((H, 4 * H), "float32"),
            "b": _sds((4 * H,), "float32"),
            "head_w": _sds((H, 1), "float32"),
            "head_b": _sds((1,), "float32")}


def _selector_fn(p):
    """The LSTMSelector module over a param dict of this rank's tensors
    (its own init made on the meta device, then replaced)."""
    from repro_torch.core.lstm import LSTMSelector
    with torch.device("meta"):
        m = LSTMSelector(*LSTMSelector.dims(p))
    for k, v in p.items():
        setattr(m, k, torch.nn.Parameter(v, requires_grad=False))
    return m


def _gather_whole(x, sharding):
    """The global tensor of this rank's slice `x`, every dimension split
    over mesh axes gathered with gather_replicated (the reference's
    partitioner's all-gather into replicated code)."""
    for dim, e in enumerate(sharding.spec):
        axes = spec_axes(e)
        if axes:
            x = coll.gather_replicated(x, sharding.mesh, axes, dim)
    return x


def _retrieval_cand_fn(cfg, spec_, mesh, shardings):
    from repro_torch.core.retrieval import clusd_candidate_retrieval
    psh = shardings[0]

    def fn(params, batch, cand_sparse, item_blocks, centroids, lstm_params,
           nb_ids, nb_sims):
        whole = tu.tree_map(_gather_whole, params, psh)
        fused = {}
        for k, v in whole.items():
            if isinstance(v, dict):
                tabs = [v[f"t{i}"] for i in range(len(v))]
                fused[k] = rs.FusedTable(torch.cat(tabs, 0),
                                         [t.shape[0] for t in tabs])
            else:
                fused[k] = v
        return clusd_candidate_retrieval(
            cfg, spec_, fused, batch, _gather_whole(cand_sparse,
                                                    shardings[2]),
            _gather_whole(item_blocks, shardings[3]), centroids,
            _selector_fn(lstm_params), nb_ids, nb_sims)
    return fn


# ---------------------------------------------------------------------------
# the paper's own system (clusd-msmarco): distributed serve step
# ---------------------------------------------------------------------------

# The serve step's data-dependent loop counts, which meta tensors cannot
# count: a SPLADE doc vector holds each term once, so a posting list holds
# a doc once (1 scatter layer a term), and the fusion merges lists that
# each hold a doc once (2 layers: a doc both sides found).
# tests/test_torch_dryrun_cells.py holds them to the counts of a served
# index whose docs hold each term once.
CLUSD_LAYERS = (1, 2)


def _serve_mesh(mesh):
    """The core.distributed ServeMesh of this rank: the model axis as it
    is, every other axis folded into "data"."""
    from repro_torch.core.distributed import ServeMesh
    nm = mesh.shape["model"]
    return ServeMesh(mesh.size // nm, nm, mesh.rank // nm,
                     mesh.coords["model"], groups=mesh._groups)


def _clusd_cell(arch, cfg, shape, mesh, multi_pod):
    """CluSD serving at MS MARCO scale. impl='shard_map' is the blocked,
    owner-sharded pipeline (core/distributed.py); impl='pjit' the
    single-host retrieve over gathered operands."""
    from repro_torch.core import distributed as dist
    nm = mesh.shape["model"]
    N, cap, dim, V = cfg.n_clusters, cfg.cluster_cap, cfg.dim, cfg.vocab
    B = shape.batch or cfg.serve_batch
    Tq = 32
    m = min(cfg.n_neighbors, N - 1)
    p_shard = max(8, cfg.max_postings // nm)
    feat_dim = 1 + cfg.u_bins + 2 * cfg.v_bins
    lstm_abs = _lstm_abstract(feat_dim, cfg.lstm_hidden)
    repl = _repl(mesh)
    rules = {}
    # placed under the installed rules (the base rules), as the reference
    # places them
    args_common = {
        "centroids": (_sds((N, dim), "float32"), repl),
        "nb_ids": (_sds((N, m), "int32"), repl),
        "nb_sims": (_sds((N, m), "float32"), repl),
        "lstm": (lstm_abs, tu.tree_map(lambda _: repl, lstm_abs)),
        "qd": (_sds((B, dim), "float32"),
               named_sharding(mesh, "queries", None)),
        "qt": (_sds((B, Tq), "int32"),
               named_sharding(mesh, "queries", None)),
        "qw": (_sds((B, Tq), "float32"),
               named_sharding(mesh, "queries", None)),
    }
    if cfg.impl == "shard_map":
        serve = dist.make_serve_step(cfg, _serve_mesh(mesh),
                                     (N, cap, dim, V, p_shard, m),
                                     feat_dim, layers=CLUSD_LAYERS)

        def fn(blocks, pd, pw, centroids, nb_ids, nb_sims, lstm, qd, qt,
               qw):
            return serve(blocks, pd, pw, centroids, nb_ids, nb_sims,
                         _selector_fn(lstm), qd, qt, qw)
        blocks = (_sds((N, cap, dim), "float32"),
                  named_sharding(mesh, "clusters", None, None))
        pd = (_sds((V, nm, p_shard), "int32"),
              NamedSharding(mesh, (None, "model", None)))
        pw = (_sds((V, nm, p_shard), "float32"),
              NamedSharding(mesh, (None, "model", None)))
        order = [blocks, pd, pw, args_common["centroids"],
                 args_common["nb_ids"], args_common["nb_sims"],
                 args_common["lstm"], args_common["qd"],
                 args_common["qt"], args_common["qw"]]
    else:  # the single-host retrieve over gathered operands
        D = N * cap
        emb = (_sds((D, dim), "float32"),
               named_sharding(mesh, "docs", None))
        cd_ = (_sds((N, cap), "int32"), repl)
        dc = (_sds((D,), "int32"), repl)
        pd = (_sds((V, cfg.max_postings), "int32"),
              NamedSharding(mesh, (None, "model")))
        pw = (_sds((V, cfg.max_postings), "float32"),
              NamedSharding(mesh, (None, "model")))
        order = [emb, args_common["centroids"], cd_, dc,
                 args_common["nb_ids"], args_common["nb_sims"],
                 pd, pw, args_common["lstm"], args_common["qd"],
                 args_common["qt"], args_common["qw"]]
        fn = _clusd_pjit_fn(cfg, [s for _, s in order])
    args = tuple(a for a, _ in order)
    shardings = tuple(s for _, s in order)
    return fn, args, shardings, rules


def _clusd_pjit_fn(cfg, shardings):
    from repro_torch.core import bins as bins_lib
    from repro_torch.core import clusd as cl
    from repro_torch.core.sparse import SparseIndex

    def fn(emb, centroids, cluster_docs, doc_cluster, nb_ids, nb_sims, pd,
           pw, lstm, qd, qt, qw):
        emb = _gather_whole(emb, shardings[0])
        pd = _gather_whole(pd, shardings[6])
        pw = _gather_whole(pw, shardings[7])
        index = cl.CluSDIndex(
            centroids=centroids, cluster_docs=cluster_docs,
            doc_cluster=doc_cluster, neighbor_ids=nb_ids,
            neighbor_sims=nb_sims, embeddings=emb,
            sparse_index=SparseIndex(pd, pw,
                                     emb.shape[0]).assume_distinct(),
            selector=_selector_fn(lstm),
            bin_ids=bins_lib.rank_bin_ids(cfg.bins, cfg.k_sparse,
                                          device=emb.device))
        ids, scores, _ = cl.retrieve(cfg, index, qd, qt, qw)
        return ids, scores
    return fn


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def cell_config(arch, overrides=None, variant="full"):
    """The `variant` config of `arch` ("smoke" for the CPU tests) with
    the caller's overrides."""
    over = dict(overrides or {})
    cfg = get_config(arch, variant)
    return dataclasses.replace(cfg, **over) if over else cfg


def build_cell(arch, shape: ShapeSpec, mesh, multi_pod=False,
               overrides=None, variant="full") -> Cell:
    """The cell of (arch, shape) on `mesh` from cell_config."""
    over = dict(overrides or {})
    cfg = cell_config(arch, overrides, variant)
    skip = cell_is_skipped(cfg, shape)
    if skip:
        raise ValueError(f"skipped cell: {skip}")
    fam = cfg.family
    if fam == "lm":
        fn, args, shardings, rules = _lm_cell(arch, cfg, shape, mesh, multi_pod)
    elif fam == "gnn":
        fn, args, shardings, rules = _gnn_cell(arch, cfg, shape, mesh, multi_pod)
    elif fam == "recsys":
        fn, args, shardings, rules = _recsys_cell(arch, cfg, shape, mesh,
                                                  multi_pod)
    elif fam == "retrieval":
        fn, args, shardings, rules = _clusd_cell(arch, cfg, shape, mesh,
                                                 multi_pod)
    else:
        raise ValueError(fam)
    return Cell(arch=arch, shape=shape, fn=fn, args=args,
                in_shardings=shardings, rules=rules,
                meta={"family": fam, "mode": shape.mode, "overrides": over},
                cfg=cfg)
