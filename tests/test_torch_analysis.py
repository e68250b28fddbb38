"""The port's dry-run analysis against the JAX package's:
repro_torch.analysis.cost (FLOPs, bytes and collectives counted per rank
as a step runs on meta tensors) against repro.analysis.hlo (the same
figures parsed from compiled HLO), the H100 spec, and the single
functions of common.tree and configs.clusd_msmarco that the slice adds.

The JAX sides run in a subprocess with 16 host devices; the port's
collectives run on one rank of torch.distributed's fake backend with 16
ranks, in a subprocess of their own.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_mesh import SRC, run_jax, spawn

_JAX_COSTS = r"""
import json, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.analysis.hlo import collective_bytes, hlo_cost
L, d = 6, 64
def scanned(ws, x):
    def body(c, w):
        return c @ w, ()
    return jax.lax.scan(body, x, ws)[0]
txt = jax.jit(scanned).lower(jax.ShapeDtypeStruct((L, d, d), jnp.float32),
    jax.ShapeDtypeStruct((d, d), jnp.float32)).compile().as_text()
out = {"scan_flops": hlo_cost(txt)["flops"]}
mesh = jax.make_mesh((4, 4), ("data", "model"))
def coll(f, spec_in, spec_out):
    g = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=spec_in,
                              out_specs=spec_out, check_vma=False))
    return collective_bytes(g.lower(jax.ShapeDtypeStruct(
        (32, 64), jnp.float32)).compile().as_text(), 16)
out["all_gather"] = coll(lambda x: jax.lax.all_gather(x, "model", axis=1,
    tiled=True), P("data", "model"), P("data", None))
out["reduce_scatter"] = coll(lambda x: jax.lax.psum_scatter(
    x, "model", scatter_dimension=0, tiled=True), P("data", None),
    P(("data", "model"), None))
out["all_reduce"] = coll(lambda x: jax.lax.psum(x, "data"),
                         P("data", "model"), P(None, "model"))
print("JSON" + json.dumps(out))
"""

_TORCH_COLL = r"""
import json, torch
from repro_torch.analysis.cost import count_step
from repro_torch.launch.dryrun import fake_process_group
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import collectives as coll
fake_process_group(16)
mesh = make_mesh((4, 4), ("data", "model"))
x = torch.empty(8, 16, device="meta")      # (32, 64) over 4 x 4
xr = torch.empty(8, 64, device="meta")     # (32, 64) over data
out = {}
for name, fn, arg in (
        ("all_gather", lambda t: coll.all_gather(t, mesh, ("model",), 1), x),
        ("reduce_scatter",
         lambda t: coll.reduce_scatter(t, mesh, ("model",), 0), xr),
        ("all_reduce", lambda t: coll.all_reduce(t, mesh, ("data",)), x)):
    coll.reset_traffic()
    _, m = count_step(fn, (arg,))
    out[name] = m.collectives()
    out[name + "_traffic"] = dict(coll.TRAFFIC)
print("JSON" + json.dumps(out))
"""


def _json(stdout):
    return json.loads(stdout.split("JSON", 1)[1])


@pytest.fixture(scope="module")
def jax_costs():
    return _json(run_jax(_JAX_COSTS, 16))


@pytest.fixture(scope="module")
def torch_coll():
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_TORCH_COLL)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    return _json(r.stdout)


def test_matmul_chain_flops_equal_jax_hlo_cost_of_the_scan(jax_costs):
    from repro_torch.analysis.cost import count_step
    L, d = 6, 64

    def chain(ws, x):
        for w in ws:
            x = x @ w
        return x
    ws = [torch.empty(d, d, device="meta") for _ in range(L)]
    _, m = count_step(chain, (ws, torch.empty(d, d, device="meta")))
    assert m.cost()["flops"] == jax_costs["scan_flops"] == L * 2 * d ** 3


def test_one_matmul_moves_its_operands_and_output_once():
    from repro_torch.analysis.cost import count_step
    a = torch.empty(48, 80, device="meta")
    b = torch.empty(80, 24, device="meta")
    _, m = count_step(lambda a, b: a @ b, (a, b))
    assert m.cost() == {"flops": 2.0 * 48 * 80 * 24,
                        "hbm_bytes": 4.0 * (48 * 80 + 80 * 24 + 48 * 24)}
    # views move nothing and make no storage; a copy reads and writes
    _, m = count_step(lambda a: a.reshape(-1)[:10].view(2, 5).t(), (a,))
    assert m.cost()["hbm_bytes"] == 0 and m.peak_live_bytes == 0
    _, m = count_step(lambda a: a.t().contiguous(), (a,))
    assert m.cost()["hbm_bytes"] == 2 * 48 * 80 * 4
    assert m.arg_bytes == 48 * 80 * 4


@pytest.mark.parametrize("kind", ["all_gather", "reduce_scatter",
                                  "all_reduce"])
def test_collective_bytes_equal_jax_on_a_4x4_mesh(jax_costs, torch_coll,
                                                  kind):
    """The port's collective over a 4 x 4 fake group counts the raw and
    wire bytes, by kind, that JAX's collective_bytes parses from the
    same shard_map on 16 host devices; raw bytes are what the port's
    TRAFFIC counter records."""
    want, got = jax_costs[kind], torch_coll[kind]
    assert got == want
    raw = {k: v for k, v in torch_coll[kind + "_traffic"].items() if v}
    assert raw == {kind: want["raw"]}


def test_reduce_scatter_tensor_path_equals_gloo_slices(tmp_path):
    """The one-collective reduce-scatter that NCCL groups and the dry
    run's fake group take gives each of 4 gloo ranks the slice that the
    gloo path's all_reduce and slice give, bitwise, on each dim and each
    axis set whose group runs in axis_index order, and counts the same
    reduce-scatter bytes; the one set out of that order ("model",
    "data") is the one the path is not taken for."""
    out = spawn("task_reduce_scatter_paths", {}, tmp_path)
    for r in out:
        assert [r[f"ordered/{t}"] for t in ("data", "model", "data_model",
                                            "model_data")] == [True] * 3 + [
                                                False]
        for tag in ("data", "model", "data_model"):
            for dim in range(3):
                one, two, t_one, t_two = r[f"{tag}/{dim}"]
                np.testing.assert_array_equal(one, two)
                assert t_one == t_two == {"all_gather": 0, "all_reduce": 0,
                                          "reduce_scatter": 4 * 8 * 12 * 8}


def test_all_gather_over_gloo_keeps_every_dtype_bitwise(tmp_path):
    """all_gather_group over each axis set of a 2 x 2 mesh of gloo ranks
    gives every rank the members' tensors in axis_index order, byte for
    byte with their dtype and shape, 16-bit floats (which gloo gathers
    as bytes) and signed zeros, NaN and -inf included, and counts the
    gathered bytes."""
    from _torch_mesh import DTYPES, _bytes, _gather_input

    out = spawn("task_gather_dtypes", {}, tmp_path)
    for r in out:
        for tag, members in r["members"].items():
            for dt in DTYPES:
                parts, traffic = r[f"{tag}/{dt}"]
                assert len(parts) == len(members) > 1
                for (d, shape, got), m in zip(parts, members):
                    want = _gather_input(m, dt)
                    assert d == str(want.dtype) and shape == (3, 5)
                    np.testing.assert_array_equal(got, _bytes(want))
                assert traffic["all_gather"] == len(members) * \
                    want.numel() * want.element_size()


def test_peak_counts_storages_alive_at_once():
    from repro_torch.analysis.cost import count_step

    def step(x):
        a = x * 2              # 4 KB
        b = a + 1              # 4 KB, a still alive
        del a
        c = b.sum()            # a freed: b and c alive
        return c
    x = torch.empty(1024, device="meta")
    _, m = count_step(step, (x,))
    assert m.arg_bytes == 4096
    assert m.peak_live_bytes == 8192
    assert m.peak_bytes() == 3 * 4096


def test_extrapolation_from_two_depths_is_exact_at_four():
    """A smoke LM cell counted at 1 and 2 layers and extrapolated to 4
    equals the count at 4 layers: FLOPs, bytes, every collective key."""
    code = r"""
import json, sys, dataclasses
from repro_torch.analysis.cost import extrapolate
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.specs import build_cell
dryrun.fake_process_group(4)
mesh = make_debug_mesh((2, 2), ("data", "model"))
shape = ShapeSpec("t", "train", seq_len=32, global_batch=8)
res = []
for L in (1, 2, 4):
    cell = build_cell("qwen2-1.5b", shape, mesh, False, {"n_layers": L},
                      "smoke")
    m, _ = dryrun.count_cell(cell, mesh, False, cell.rules)
    res.append({"cost": m.cost(), "coll": m.collectives()})
print("JSON" + json.dumps([extrapolate(res[0], res[1], 4), res[2]]))
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    ext, at4 = _json(r.stdout)
    assert ext == at4
    assert at4["coll"]["count"] > 0 and at4["cost"]["flops"] > 0


def test_h100_spec_is_the_datasheet():
    from repro_torch.common.hw import H100_SXM
    assert H100_SXM.peak_flops_bf16 == 989.4e12
    assert H100_SXM.hbm_bandwidth == 3.35e12
    assert H100_SXM.hbm_bytes == 80e9
    assert H100_SXM.link_bandwidth == 50e9
    assert H100_SXM.nvlink_bandwidth == 450e9
    assert (H100_SXM.n_sms, H100_SXM.smem_bytes_per_sm,
            H100_SXM.l2_bytes) == (132, 228 * 1024, 50 * 2 ** 20)


_JAX_TREE = r"""
import json, numpy as np, jax, jax.numpy as jnp
from repro.common import tree as t
from repro.configs import clusd_msmarco as c
import dataclasses
a = {"w": jnp.asarray(np.arange(6, dtype=np.float32).reshape(2, 3)),
     "b": {"x": jnp.asarray([3.0, -4.0], jnp.float32),
           "i": jnp.asarray([1, 2], jnp.int32)}}
clipped, norm = t.clip_by_global_norm({"w": a["w"], "x": a["b"]["x"]}, 2.0)
out = {"add": np.asarray(t.tree_add(a, a)["w"]).tolist(),
       "clip_w": np.asarray(clipped["w"]).tolist(),
       "clip_x": np.asarray(clipped["x"]).tolist(), "norm": float(norm),
       "count": t.param_count(a), "bytes": t.param_bytes(a),
       "cast": [str(x.dtype) for x in jax.tree.leaves(
           t.cast_tree(a, jnp.bfloat16))],
       "ondisk": dataclasses.asdict(c.ondisk()),
       "repllama": dataclasses.asdict(c.repllama())}
print("JSON" + json.dumps(out))
"""


def test_tree_functions_and_clusd_configs_equal_jax():
    import dataclasses
    from repro_torch.common import tree as t
    from repro_torch.configs import clusd_msmarco as c
    want = _json(run_jax(_JAX_TREE, 1))
    a = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "b": {"x": torch.tensor([3.0, -4.0]),
               "i": torch.tensor([1, 2], dtype=torch.int32)}}
    assert t.tree_add(a, a)["w"].tolist() == want["add"]
    clipped, norm = t.clip_by_global_norm({"w": a["w"], "x": a["b"]["x"]},
                                          2.0)
    np.testing.assert_allclose(float(norm), want["norm"], rtol=1e-7)
    np.testing.assert_allclose(clipped["w"].numpy(), want["clip_w"],
                               rtol=1e-6)
    np.testing.assert_allclose(clipped["x"].numpy(), want["clip_x"],
                               rtol=1e-6)
    assert t.param_count(a) == want["count"]
    assert t.param_bytes(a) == want["bytes"]
    assert [str(x.dtype).replace("torch.", "") for x in t.tree_leaves(
        t.cast_tree(a, torch.bfloat16))] == want["cast"]
    for name in ("ondisk", "repllama"):
        got = dataclasses.asdict(getattr(c, name)())
        assert json.loads(json.dumps(got)) == want[name]


def test_breakdown_sites_add_up_to_the_cell_total():
    """collective_breakdown's (kind, shape, op) sites of a smoke cell sum
    to the cell's wire bytes, and each names the frame of this package
    that issued it."""
    code = r"""
import json
from repro_torch.analysis.breakdown import cell_sites, collective_breakdown
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
dryrun.fake_process_group(4)
mesh = make_debug_mesh((2, 2), ("data", "model"))
sites, total = cell_sites("mixtral-8x7b", ShapeSpec("t", "train", seq_len=16,
    global_batch=8), False, {"n_layers": 3}, mesh=mesh, variant="smoke")
top = collective_breakdown(sites, 1000)
print("JSON" + json.dumps({"total": total["wire"],
                           "sum": sum(w for _, w in top),
                           "ops": [k[2] for k, _ in top],
                           "kinds": sorted({k[0] for k, _ in top})}))
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    got = _json(r.stdout)
    np.testing.assert_allclose(got["sum"], got["total"], rtol=1e-12)
    assert got["kinds"] == ["all-gather", "all-reduce", "reduce-scatter"]
    assert all(op.startswith("models/") for op in got["ops"]), got["ops"]
