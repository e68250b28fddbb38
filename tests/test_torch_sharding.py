"""The port's logical-axis sharding, meshes, collectives and elastic
restore (repro_torch.models.{sharding,collectives}, launch.mesh,
checkpoint) against the JAX package's.

  * BASE_RULES, install_rules (pod_dp before the overrides) and spec
    equal JAX's for every axes tuple of the transformer, nequip and cache
    templates; param_shardings leaf for leaf for the qwen2, mixtral,
    arctic and nequip smoke configs, and the abstract templates
  * a rank's slice equals the one jax.device_put gives the device of its
    id on 4 host devices (2 x 2, 1 x 4, (4,), tuples of axes in either
    order); shard then gather on 4 gloo ranks is bitwise the global
    array; a dimension that does not divide raises, as JAX raises
  * make_production_mesh raises with too few ranks, as JAX does
  * each collective's backward on 4 gloo ranks is its stated transpose,
    computed in numpy from every rank's cotangent (float64, rtol 1e-12)
  * elastic restore: a tree saved from a (4,) data mesh restored on
    2 x 2 with ("model", "data"), bitwise, each rank's slice the one
    JAX's device_put gives
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax

from _torch_mesh import run_jax, spawn
from repro.models import sharding as jsh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import sharding as tsh

ARCHS = ["qwen2-1.5b", "mixtral-8x7b", "arctic-480b"]


def _jax_templates():
    from repro.configs import get_config
    from repro.models import nequip as jn
    from repro.models import transformer as jt

    out = {}
    for arch in ARCHS:
        for variant in ("smoke", "full"):
            cfg = get_config(arch, variant)
            out[f"{arch}/{variant}"] = jt.param_template(cfg)
            out[f"{arch}/{variant}/cache"] = jt.cache_template(cfg, 8, 64)
    out["nequip"] = jn.param_template(get_config("nequip", "smoke"))
    return out


def _axes_tuples():
    seen = set()

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            seen.add(tuple(t.axes))
    walk(_jax_templates())
    return sorted(seen, key=str)


@pytest.mark.parametrize("rules,pod", [
    (None, False), ({}, True), ({"batch": None}, True),
    ({"embed_w": None, "heads": ("data", "model")}, False)])
def test_rules_and_spec_equal_jax(rules, pod):
    assert tsh.BASE_RULES == jsh.BASE_RULES
    tt = tsh.install_rules(rules, None, pod)
    jt = jsh.install_rules(rules, None, pod)
    try:
        assert tt == jt
        assert tsh.current_rules() == jsh.current_rules()
        tuples = _axes_tuples()
        assert len(tuples) > 10
        for names in tuples + [(), ("queries", "docs"), ("edges",)]:
            assert tsh.spec(*names) == tuple(jsh.spec(*names)), names
    finally:
        tsh._state.rules = tsh._state.mesh = None
        jsh._state.rules = jsh._state.mesh = None


def test_rules_ctx_restores_and_is_per_thread():
    seen = {}
    with tsh.rules_ctx({"batch": None}, mesh="m1"):
        assert tsh.current_rules()["batch"] is None
        assert tsh.current_mesh() == "m1"

        def other():
            seen["rules"], seen["mesh"] = (tsh.current_rules(),
                                           tsh.current_mesh())
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with pytest.raises(KeyError):
            with tsh.rules_ctx({}, mesh="m2", pod_dp=True):
                assert tsh.current_rules()["batch"] == ("pod", "data")
                raise KeyError("x")
        assert tsh.current_mesh() == "m1"
    assert tsh.current_rules() is None and tsh.current_mesh() is None
    assert seen == {"rules": None, "mesh": None}
    # logical is a no-op without a mesh, and checks the local shape with
    x = torch.zeros(4, 6)
    assert tsh.logical(x, "batch", "embed") is x
    mesh = tmesh.Mesh((2, 2), ("data", "model"), rank=3)
    with tsh.rules_ctx({}, mesh=mesh):
        assert tsh.logical(x, "batch", "heads", shape=(8, 12)) is x
        with pytest.raises(ValueError, match="implies"):
            tsh.logical(x, "batch", "heads", shape=(4, 12))
        with pytest.raises(ValueError, match="logical names"):
            tsh.logical(x, "batch")


@pytest.mark.parametrize("arch", ARCHS + ["nequip"])
def test_param_shardings_and_abstract_templates_equal_jax(arch):
    from repro.configs import get_config as jget
    from repro_torch.common import tree as tu
    from repro_torch.configs import get_config as tget

    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    tm = tmesh.Mesh((1, 1), ("data", "model"))
    if arch == "nequip":
        from repro.models import nequip as jm
        from repro_torch.models import nequip as tmod
        args = [(get(arch, "smoke"),) for get in (jget, tget)]
        tc = args[1][0]
    else:
        from repro.models import transformer as jm
        from repro_torch.models import transformer as tmod
        over = dict(n_experts=16, moe_impl="ep_shard_map") \
            if arch == "arctic-480b" else {}
        args = [(dataclasses.replace(get(arch, "smoke"), **over),)
                for get in (jget, tget)]
        tc = args[1][0]
        assert tmod._expert_parallel(tc) == jm._expert_parallel(args[0][0])
    for pod in (False, True):
        names = ("pod", "data", "model") if pod else ("data", "model")
        jm_ = jax.make_mesh((1,) * len(names), names, axis_types=(
            jax.sharding.AxisType.Auto,) * len(names))
        tm_ = tmesh.Mesh((1,) * len(names), names)
        with jsh.rules_ctx({}, mesh=jm_, pod_dp=pod), \
                tsh.rules_ctx({}, mesh=tm_, pod_dp=pod):
            js = jm.param_shardings(*args[0], jm_)
            ts = tmod.param_shardings(*args[1], tm_)
            jflat = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
                     jax.tree_util.tree_flatten_with_path(js)[0]}
            tflat = {p: s.spec for p, s in tu.leaf_paths(ts)}
            assert tflat == jflat
    ja = jm.abstract_params(*args[0])
    ta = tmod.abstract_params(*args[1])
    jflat = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype)) for p, a
             in jax.tree_util.tree_flatten_with_path(ja)[0]}
    tflat = {p: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
             for p, a in tu.leaf_paths(ta)}
    assert tflat == jflat
    assert all(a.device.type == "meta" for a in tu.tree_leaves(ta))
    if arch != "nequip":
        jc = jm.abstract_cache(args[0][0], 8, 64)
        tcache = tmod.abstract_cache(tc, 8, 64)
        for k in ("k", "v"):
            assert tuple(tcache[k].shape) == tuple(jc[k].shape)
        with jsh.rules_ctx({}, mesh=jmesh), tsh.rules_ctx({}, mesh=tm):
            jcs = jm.cache_shardings(args[0][0], jmesh, 8, 64)
            tcs = tmod.cache_shardings(tc, tm, 8, 64)
            assert tcs["k"].spec == tuple(jcs["k"].spec)


_JAX_SLICES = r"""
import numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
cases = CASES
out = {}
for i, (shape, axes, spec, gshape) in enumerate(cases):
    mesh = jax.make_mesh(tuple(shape), tuple(axes),
        axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    x = np.arange(int(np.prod(gshape)), dtype=np.float32).reshape(gshape)
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    try:
        y = jax.device_put(x, NamedSharding(mesh, P(*spec)))
    except ValueError as e:
        out[f"err{i}"] = np.asarray(str(e))
        continue
    for s in y.addressable_shards:
        out[f"c{i}_d{s.device.id}"] = np.asarray(s.data)
np.savez(OUT, **out)
"""

CASES = [((2, 2), ("data", "model"), ("data", None), (8, 6)),
         ((2, 2), ("data", "model"), (None, "model"), (4, 6)),
         ((2, 2), ("data", "model"), ("model", "data"), (8, 6)),
         ((2, 2), ("data", "model"), (("model", "data"), None), (8, 3)),
         ((2, 2), ("data", "model"), (("data", "model"), None), (8, 3)),
         ((1, 4), ("data", "model"), (None, "model", None), (2, 8, 3)),
         ((4,), ("data",), ("data",), (12,)),
         ((2, 2), ("data", "model"), ("data", None), (3, 4))]


def test_shard_and_gather_match_jax_device_put(tmp_path):
    out = str(tmp_path / "jax.npz")
    run_jax(_JAX_SLICES.replace("CASES", repr(
        [[list(s), list(a), [list(e) if isinstance(e, tuple) else e
                             for e in sp], list(g)]
         for s, a, sp, g in CASES])).replace("OUT", repr(out)))
    want = dict(np.load(out))
    job = {"cases": []}
    for i, (shape, axes, spec, gshape) in enumerate(CASES):
        x = np.arange(int(np.prod(gshape)), dtype=np.float32).reshape(gshape)
        m = tmesh.Mesh(shape, axes, rank=0)
        s = tsh.NamedSharding(m, spec)
        if f"err{i}" in want:                        # JAX raised: so do we
            with pytest.raises(ValueError, match="divides"):
                s.shard(x)
            continue
        # the slice of each rank without a process group
        for r in range(int(np.prod(shape))):
            got = tsh.NamedSharding(tmesh.Mesh(shape, axes, rank=r),
                                    spec).shard(torch.from_numpy(x))
            np.testing.assert_array_equal(got.numpy(), want[f"c{i}_d{r}"])
        job["cases"].append((list(shape), list(axes), [
            list(e) if isinstance(e, tuple) else e for e in spec]))
        job[f"x{len(job['cases']) - 1}"] = x
    assert len(job["cases"]) == len(CASES) - 1
    outs = spawn("task_roundtrip", job, tmp_path)
    for r, o in enumerate(outs):
        for i in range(len(job["cases"])):
            assert o[f"whole{i}"].tobytes() == job[f"x{i}"].tobytes()
    with pytest.raises(RuntimeError, match="process group"):
        tsh.NamedSharding(tmesh.Mesh((2, 2), ("data", "model")),
                          ("data", None)).gather(torch.zeros(2, 2))


def test_production_mesh_raises_with_too_few_ranks():
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    out = run_jax("""
        from repro.launch.mesh import make_production_mesh
        for mp in (False, True):
            try:
                make_production_mesh(multi_pod=mp)
            except RuntimeError as e:
                print("raised", mp)
    """)
    assert out.split() == ["raised", "False", "raised", "True"]
    with pytest.raises(RuntimeError, match="torch.distributed"):
        tmesh.make_debug_mesh((2, 2))
    m = tmesh.make_debug_mesh((1, 1))
    assert m.shape == {"data": 1, "model": 1} and m.group("data") is None
    m = tmesh.Mesh((2, 3, 4), ("pod", "data", "model"), rank=17)
    assert m.coords == dict(zip(("pod", "data", "model"),
                                np.unravel_index(17, (2, 3, 4))))
    assert m.axis_index(("model", "pod")) == 1 * 2 + 1
    assert m.members(("model",)) == [16, 17, 18, 19]


def _transpose(name, axes, outs, coords):
    """The stated backward of `name` on every rank from every rank's
    cotangent, in numpy: {rank: gx}."""
    order = {"data": 0, "model": 1}

    def index(c, ax):
        i = 0
        for a in ax:
            i = i * 2 + c[order[a]]
        return i

    def line(r):
        return [q for q in range(4) if all(
            coords[q][order[a]] == coords[r][order[a]]
            for a in ("data", "model") if a not in axes)]
    tag = "_".join(axes)
    n = 2 ** len(axes)
    res = {}
    for r in range(4):
        cts = {q: outs[q][f"{name}/{tag}/ct"] for q in line(r)}
        me = index(coords[r], axes)
        if name == "all_gather":
            tot = sum(cts.values())
            res[r] = np.split(tot, n)[me]
        elif name == "reduce_scatter":
            parts = sorted(line(r), key=lambda q: index(coords[q], axes))
            res[r] = np.concatenate([cts[q] for q in parts])
        elif name == "copy_to":
            res[r] = sum(cts.values())
        elif name == "all_reduce":
            res[r] = cts[r]
        elif name == "pmean":
            res[r] = cts[r] / n
        else:                                     # gather_replicated
            res[r] = np.split(cts[r], n)[me]
    return res


def test_collectives_backward_is_their_transpose(tmp_path):
    outs = spawn("task_collectives", {}, tmp_path)
    coords = [o["coords"] for o in outs]
    assert sorted(coords) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for axes in (("data",), ("model",), ("data", "model"),
                 ("model", "data")):
        tag = "_".join(axes)
        for name in ("all_gather", "reduce_scatter", "copy_to",
                     "all_reduce", "pmean", "gather_replicated"):
            want = _transpose(name, axes, outs, coords)
            for r in range(4):
                np.testing.assert_allclose(outs[r][f"{name}/{tag}/gx"],
                                           want[r], rtol=1e-12, atol=0)
            # forwards: the gathers and sums they state
            xs = [o[f"{name}/{tag}/x"] for o in outs]
            if name == "all_reduce":
                members = [q for q in range(4) if all(
                    coords[q][i] == coords[0][i] for i, a in
                    enumerate(("data", "model")) if a not in axes)]
                np.testing.assert_allclose(
                    outs[0][f"{name}/{tag}/y"],
                    sum(xs[q] for q in members), rtol=1e-12)
            if name == "copy_to":
                assert outs[1][f"{name}/{tag}/y"].tobytes() == \
                    xs[1].tobytes()


_JAX_ELASTIC = r"""
import numpy as np, jax, tempfile
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import restore_checkpoint
mesh4 = jax.make_mesh((2, 2), ("data", "model"),
    axis_types=(jax.sharding.AxisType.Auto,) * 2)
w = np.arange(64.0, dtype=np.float32).reshape(8, 8)
tree = {"w": jax.numpy.asarray(w)}
sh = {"w": NamedSharding(mesh4, P("model", "data"))}
restored, _ = restore_checkpoint(DIR, 5, tree, sh)
out = {f"d{s.device.id}": np.asarray(s.data)
       for s in restored["w"].addressable_shards}
out["whole"] = np.asarray(restored["w"])
np.savez(OUT, **out)
"""


def test_elastic_restore_from_data_mesh_to_2x2(tmp_path):
    from repro_torch.checkpoint import read_checkpoint

    w = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    d = str(tmp_path / "ck")
    outs = spawn("task_elastic", {"w": w, "dir": d,
                                  "spec": ["model", "data"]}, tmp_path)
    arrays, _ = read_checkpoint(d, 5)
    assert arrays["['w']"].tobytes() == w.tobytes()     # one-device layout
    out = str(tmp_path / "jax.npz")
    run_jax(_JAX_ELASTIC.replace("DIR", repr(d)).replace("OUT", repr(out)))
    want = dict(np.load(out))
    assert want["whole"].tobytes() == w.tobytes()       # JAX reads it
    for r, o in enumerate(outs):
        assert o["saved"].tobytes() == w[2 * r:2 * r + 2].tobytes()
        assert o["restored"].tobytes() == want[f"d{r}"].tobytes()
    assert sorted(o["coords"] for o in outs) == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]
