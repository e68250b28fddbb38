"""The port's dry-run cells (repro_torch.launch.specs.build_cell) against
the JAX package's (repro.launch.specs.build_cell): for every cell of
configs.cells() and CluSD's retrieval shapes, on the 16 x 16 and the
2 x 16 x 16 production meshes, every argument's global shape, dtype and
PartitionSpec, each package's cells with no overrides (the reference's
defaults: "sort" for the MoE, "pjit" for NequIP); the skipped cells'
reasons; model_flops bitwise; roofline_terms on the same inputs and
spec numbers; and nequip minibatch_lg's default msg_impl "pjit" given
explicitly, its cell against JAX's and its collective bytes counted on
a fake 16 x 16 group. JAX builds its cells in a subprocess with 512 host
devices; the port's cells are built on a Mesh of rank 0 (no process
group: building a cell runs no collective).
"""

import json
import os

import pytest

from _torch_mesh import run_jax

_JAX = r"""
import json, jax
from jax.sharding import NamedSharding
from repro.analysis.roofline import model_flops, roofline_terms
from repro.common.hw import TPU_V5E
from repro.configs import cells, get_config
from repro.configs.shapes import shapes_for
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import build_cell
todo = [(a, s) for a, s, _ in cells()] + [
    ("clusd-msmarco", s) for s in shapes_for("retrieval").values()]
out = {"cells": {}, "flops": {}}
def norm(spec):
    parts = [list(e) if isinstance(e, tuple) else e for e in spec]
    while parts and parts[-1] is None:
        parts.pop()
    return parts
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch, shape in todo:
        key = f"{arch}|{shape.name}|{int(multi)}"
        try:
            cell = build_cell(arch, shape, mesh, multi_pod=multi)
        except ValueError as e:
            out["cells"][key] = {"error": str(e)}
            continue
        args = jax.tree_util.tree_flatten_with_path(cell.args)[0]
        shs = jax.tree.leaves(cell.in_shardings,
                              is_leaf=lambda x: isinstance(x, NamedSharding))
        out["cells"][key] = {
            "args": [[jax.tree_util.keystr(p), list(a.shape), str(a.dtype),
                      norm(s.spec)] for (p, a), s in zip(args, shs)],
            "rules": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in cell.rules.items()}}
for arch, shape in todo:
    out["flops"][f"{arch}|{shape.name}"] = model_flops(get_config(arch),
                                                       shape)
# NequIP's own default message pass on the 16 x 16 mesh
cell = build_cell("nequip", shapes_for("gnn")["minibatch_lg"],
                  make_production_mesh(multi_pod=False), multi_pod=False,
                  overrides={"msg_impl": "pjit"})
args = jax.tree_util.tree_flatten_with_path(cell.args)[0]
shs = jax.tree.leaves(cell.in_shardings,
                      is_leaf=lambda x: isinstance(x, NamedSharding))
out["pjit"] = {
    "args": [[jax.tree_util.keystr(p), list(a.shape), str(a.dtype),
              norm(s.spec)] for (p, a), s in zip(args, shs)],
    "rules": {k: list(v) if isinstance(v, tuple) else v
              for k, v in cell.rules.items()}}
cost = {"flops": 3.7e15, "bytes accessed": 2.9e12}
coll = {"wire": 4.1e10, "raw": 4.4e10}
out["terms"] = roofline_terms(cost, coll, 256, TPU_V5E)
out["spec"] = [TPU_V5E.name, TPU_V5E.peak_flops_bf16, TPU_V5E.hbm_bandwidth,
               TPU_V5E.hbm_bytes, TPU_V5E.ici_link_bandwidth]
print("JSON" + json.dumps(out))
"""


def _todo():
    from repro_torch.configs import cells
    from repro_torch.configs.shapes import shapes_for
    return [(a, s) for a, s, _ in cells()] + [
        ("clusd-msmarco", s) for s in shapes_for("retrieval").values()]


def _flatten(x, prefix=""):
    if isinstance(x, dict):
        return [kv for k in sorted(x) for kv in _flatten(x[k],
                                                         f"{prefix}[{k!r}]")]
    if isinstance(x, (list, tuple)):
        return [kv for i, v in enumerate(x)
                for kv in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, x)]


def _norm(spec):
    parts = [list(e) if isinstance(e, tuple) else e for e in spec]
    while parts and parts[-1] is None:
        parts.pop()
    return parts


def _cell_record(cell):
    args = _flatten(cell.args)
    shs = [s for _, s in _flatten(cell.in_shardings)]
    return {"args": [[p, list(a.shape), str(a.dtype).replace("torch.", ""),
                      _norm(s.spec)] for (p, a), s in zip(args, shs)],
            "rules": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in cell.rules.items()},
            "overrides": cell.meta["overrides"]}


def _port_cells():
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import build_cell
    out = {}
    for multi in (False, True):
        mesh = Mesh((2, 16, 16), ("pod", "data", "model")) if multi \
            else Mesh((16, 16), ("data", "model"))
        for arch, shape in _todo():
            key = f"{arch}|{shape.name}|{int(multi)}"
            try:
                cell = build_cell(arch, shape, mesh, multi_pod=multi)
            except ValueError as e:
                out[key] = {"error": str(e)}
                continue
            out[key] = _cell_record(cell)
    return out


@pytest.fixture(scope="module")
def both():
    want = json.loads(run_jax(_JAX, 512).split("JSON", 1)[1])
    return want, _port_cells()


def test_every_cell_is_built_on_both_meshes(both):
    want, got = both
    assert sorted(got) == sorted(want["cells"])
    assert len(got) == 2 * len(_todo()) == 82


@pytest.mark.parametrize("multi", [0, 1], ids=["16x16", "2x16x16"])
def test_shapes_dtypes_and_specs_equal_jax(both, multi):
    want, got = both
    n = 0
    for key, w in want["cells"].items():
        if not key.endswith(f"|{multi}") or "error" in w:
            continue
        g = got[key]
        assert g["args"] == w["args"], key
        assert g["rules"] == w["rules"], key
        n += 1
    assert n == 37


def test_skipped_cells_raise_the_same_text(both):
    want, got = both
    skipped = [k for k, w in want["cells"].items() if "error" in w]
    assert len(skipped) == 8
    for k in skipped:
        assert got[k] == {"error": want["cells"][k]["error"]}


def test_port_overrides_are_the_sharded_implementations(both):
    """The port sets no implementation of its own: every default cell
    counts the reference's config ("sort" for the MoE, "pjit" for
    NequIP), and the shard_map variants are the caller's overrides."""
    from repro_torch.configs.shapes import shapes_for
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import build_cell, cell_config

    _, got = both
    for key in ("mixtral-8x7b|train_4k|0", "arctic-480b|decode_32k|1",
                "nequip|minibatch_lg|0", "qwen2-1.5b|train_4k|0"):
        assert got[key]["overrides"] == {}, key
    assert cell_config("mixtral-8x7b").moe_impl == "sort"
    assert cell_config("arctic-480b").moe_impl == "sort"
    assert cell_config("nequip").msg_impl == "pjit"
    over = {"moe_impl": "tp_shard_map"}
    assert cell_config("mixtral-8x7b", over).moe_impl == "tp_shard_map"
    cell = build_cell("mixtral-8x7b", shapes_for("lm")["train_4k"], Mesh(
        (16, 16), ("data", "model")), overrides=over)
    assert cell.meta["overrides"] == over


_PJIT_COUNT = r"""
import json
from repro_torch.configs.shapes import shapes_for
from repro_torch.launch import dryrun
rec = dryrun.run_cell("nequip", shapes_for("gnn")["minibatch_lg"], False,
                      overrides={"msg_impl": "pjit"})
print("JSON" + json.dumps(rec))
"""


def test_nequip_pjit_cell_is_jax_and_counts_whole_node_aggregates(both):
    """nequip minibatch_lg with the reference's default msg_impl "pjit"
    (the CLI's --set msg_impl=pjit): its arguments, placements and rules
    are JAX's build_cell's with the same override. Counted on one rank of
    a fake 16 x 16 group, each layer all-reduces the whole (N, C, 9)
    float32 aggregate twice (the forward's sum over the edge shards, the
    backward's of the packed node features' cotangent), the step adds
    the three radial weights' gradients, and the node arrays are gathered
    whole once: the bytes of the design that keeps every tensor whole, an
    upper bound on what a partitioner would move."""
    import subprocess
    import sys

    from _torch_mesh import SRC
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import shapes_for
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.nequip import N_PATHS, RADIAL_HIDDEN

    want, _ = both
    shape = shapes_for("gnn")["minibatch_lg"]
    cell = build_cell("nequip", shape, Mesh((16, 16), ("data", "model")),
                      overrides={"msg_impl": "pjit"})
    got = _cell_record(cell)
    assert got["overrides"] == {"msg_impl": "pjit"}
    assert got["args"] == want["pjit"]["args"]
    assert got["rules"] == want["pjit"]["rules"] == {"nodes": ["data"]}
    r = subprocess.run([sys.executable, "-c", _PJIT_COUNT],
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0, r.stderr[-4000:]
    rec = json.loads(r.stdout.split("JSON", 1)[1])
    batch = dict(zip([p for p, _ in _flatten(cell.args[2])],
                     [a for _, a in _flatten(cell.args[2])]))
    N, d_feat = batch["['node_feat']"].shape
    cfg = get_config("nequip")
    L, C = cfg.n_layers, cfg.d_hidden
    radial = (cfg.n_rbf * RADIAL_HIDDEN + RADIAL_HIDDEN
              + RADIAL_HIDDEN * N_PATHS * C) * 4
    coll = rec["collectives"]
    assert rec["status"] == "ok" and rec["n_layers"] == L
    assert coll["all-reduce_raw"] == L * (2 * N * C * 9 * 4 + radial)
    assert coll["all-gather_raw"] == N * (3 + d_feat + 1) * 4
    assert coll["count"] == 3 + 2 * L + 3
    assert "reduce-scatter_raw" not in coll


def test_model_flops_bitwise_jax(both):
    from repro_torch.analysis.roofline import model_flops
    from repro_torch.configs import get_config
    want, _ = both
    for arch, shape in _todo():
        assert model_flops(get_config(arch), shape) == \
            want["flops"][f"{arch}|{shape.name}"], (arch, shape.name)


def test_roofline_terms_equal_jax_on_the_same_spec(both):
    from repro_torch.analysis.roofline import roofline_terms
    from repro_torch.common.hw import HardwareSpec
    want, _ = both
    name, peak, hbm, cap, link = want["spec"]
    hw = HardwareSpec(name=name, peak_flops_bf16=peak, hbm_bandwidth=hbm,
                      hbm_bytes=cap, link_bandwidth=link)
    got = roofline_terms({"flops": 3.7e15, "bytes accessed": 2.9e12},
                         {"wire": 4.1e10, "raw": 4.4e10}, 256, hw)
    assert got == want["terms"]


def test_clusd_cells_loop_counts_are_a_served_index_counts(monkeypatch):
    """The loop counts that the CluSD cells supply (specs.CLUSD_LAYERS),
    since meta tensors cannot count them, are the counts the port's serve
    step makes on a served index whose docs hold each term once, as
    SPLADE's doc vectors do (the JAX smoke state's index, its postings
    rebuilt from the corpus with each doc's repeated terms dropped; 16
    queries, one rank), and serving with them gives bitwise what counting
    gives. (The synthetic corpus itself repeats terms: its lists hold a
    doc up to 3 times.)"""
    import numpy as np

    from _torch_parity import index_arrays, jax_smoke_state, torch_cfg
    from repro.data import synth_queries
    from repro_torch.convert import index_from_numpy
    from repro_torch.core import distributed as tdd
    from repro_torch.core import features as feat_lib
    from repro_torch.core import fusion
    from repro_torch.core.sparse import SparseIndex
    from repro_torch.launch.specs import CLUSD_LAYERS

    jcfg, index, corpus = jax_smoke_state(0)
    cfg = torch_cfg(jcfg)
    terms = np.array(corpus.doc_terms)
    T = terms.shape[1]
    again = ((terms[:, :, None] == terms[:, None, :])
             & np.tri(T, T, -1, dtype=bool)[None]).any(-1)
    arrays = index_arrays(index)
    pd, pw, _ = SparseIndex.build_arrays(
        np.where(again, -1, terms), np.asarray(corpus.doc_weights),
        cfg.vocab, cfg.max_postings)
    arrays.update(sparse_postings_docs=pd, sparse_postings_weights=pw)
    bidx = tdd.build_blocked_index(
        cfg, index_from_numpy(arrays, device="cpu"),
        np.asarray(corpus.embeddings))
    mesh = tdd.make_mesh(1, 1)
    runner = tdd.ServeRunner.from_blocked(cfg, mesh, bidx, device="cpu")
    qs = synth_queries(7, corpus, 16)
    q3 = tuple(np.asarray(x) for x in (qs.q_dense, qs.q_terms,
                                       qs.q_weights))
    seen = {"occ": [], "merge": []}
    occ, fold = tdd._occurrence_ranks, fusion._fold_runs

    def count_occ(*a):
        rank, n = occ(*a)
        seen["occ"].append(n)
        return rank, n

    def count_merge(c, seg, rank, n):
        seen["merge"].append(n)
        return fold(c, seg, rank, n)
    monkeypatch.setattr(tdd, "_occurrence_ranks", count_occ)
    monkeypatch.setattr(fusion, "_fold_runs", count_merge)
    ids, scores = runner(*q3)
    assert (max(seen["occ"]), max(seen["merge"])) == CLUSD_LAYERS
    N, (cap, dim), (V, _, P) = (runner.centroids.shape[0],
                                runner.blocks.shape[1:], runner.pd.shape)
    runner.step = tdd.make_serve_step(
        cfg, mesh, (N, cap, dim, V, P, runner.nb_ids.shape[1]),
        feat_lib.feature_dim(cfg), layers=CLUSD_LAYERS)
    ids2, scores2 = runner(*q3)
    assert seen["occ"][-1:] + seen["merge"][-1:] == list(CLUSD_LAYERS)
    assert np.array_equal(ids.numpy(), ids2.numpy())
    assert scores.numpy().tobytes() == scores2.numpy().tobytes()
