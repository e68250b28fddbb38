"""The port's sharded MoE dispatches (repro_torch.models.moe.
moe_ffn_{ep,tp}_shardmap) on 4 gloo ranks against the JAX package's
inside shard_map on 4 host devices, on the same meshes (2 x 2 and
1 x 4) and the inputs of tests/test_moe_dispatch.py.

Each rank routes its own tokens with its own capacity, so the reference
is JAX's sharded function on the same mesh shape, not the global
moe_ffn (which drops other pairs once a shard overflows); where nothing
drops the global moe_ffn agrees too. Tolerances (float32 on the CPU,
the model-axis sums added in another order): outputs and aux within
1e-4 absolute, as JAX's own test; gradients of sum(out * ct) + 0.3 * aux
rtol 1e-4, atol 1e-5; the router's expert ids equal at every token whose
top-3 probabilities are 1e-6 apart.
"""

import numpy as np
import pytest

from _torch_mesh import run_jax, spawn

T, D, F, E, K = 64, 32, 16, 8, 2
CASES = [("tp", (2, 2)), ("ep", (2, 2)), ("tp", (1, 4)), ("ep", (1, 4)),
         ("tp", (4, 1)), ("ep", (2, 2), "drop"), ("tp", (2, 2), "drop")]

_JAX = r"""
import json, numpy as np, jax, jax.numpy as jnp
from repro.models import moe
job = dict(np.load(JOB))
cases = json.loads(str(job["cases"]))
out = {}
for i, (mode, shape, x_key) in enumerate(cases):
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    fn = moe.moe_ffn_ep_shardmap if mode == "ep" else moe.moe_ffn_tp_shardmap
    args = [jnp.asarray(job[k]) for k in (x_key, "rw", "wg", "wu", "wd")]
    def loss(*a):
        y, aux = fn(*a, top_k=2, mesh=mesh)
        return jnp.sum(y * job["ct"]) + float(job["c_aux"]) * aux, (y, aux)
    (l, (y, aux)), g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*args)
    out[f"y{i}"], out[f"aux{i}"] = np.asarray(y), np.asarray(aux)
    for j, gj in enumerate(g):
        out[f"g{i}_{j}"] = np.asarray(gj)
    if i == 0:
        ref, _ = jax.jit(lambda *a: moe.moe_ffn(*a, top_k=2, ep=False))(*args)
        out["global"] = np.asarray(ref)
for k in ("x", "x_drop"):
    p = jax.nn.softmax(jnp.asarray(job[k]) @ jnp.asarray(job["rw"]), -1)
    out[f"probs_{k}"] = np.asarray(p)
    out[f"eidx_{k}"] = np.asarray(jax.lax.top_k(p, 2)[1])
np.savez(OUT, **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((T, D)) * 0.5).astype(np.float32)
    rw = (rng.standard_normal((D, E)) * 0.3).astype(np.float32)
    wg = (rng.standard_normal((E, D, F)) * 0.2).astype(np.float32)
    wu = (rng.standard_normal((E, D, F)) * 0.2).astype(np.float32)
    wd = (rng.standard_normal((E, F, D)) * 0.2).astype(np.float32)
    # one token repeated over the first 40 rows: its pairs overflow the
    # two experts it picks on the shard(s) that hold them
    x_drop = x.copy()
    x_drop[:40] = x[3]
    ct = rng.standard_normal((T, D)).astype(np.float32)
    return dict(x=x, rw=rw, wg=wg, wu=wu, wd=wd, x_drop=x_drop, ct=ct,
                c_aux=np.float32(0.3))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import json

    tmp = tmp_path_factory.mktemp("moe_mesh")
    job = _inputs()
    cases = [(c[0], list(c[1]), "x_drop" if len(c) > 2 else "x")
             for c in CASES]
    jpath, out = str(tmp / "job.npz"), str(tmp / "jax.npz")
    np.savez(jpath, cases=json.dumps(cases), **job)
    run_jax(_JAX.replace("JOB", repr(jpath)).replace("OUT", repr(out)))
    want = dict(np.load(out))
    tjob = dict(job, c_aux=float(job["c_aux"]), cases=[
        {"mode": m, "mesh": s, "x": job[k]} for m, s, k in cases])
    got = spawn("task_moe", tjob, tmp)
    return job, cases, want, got


def _assemble(i, case, job, got):
    """The global output and gradients from the ranks' slices: rows by
    data index, weights summed over data and joined over model."""
    mode, (nd, nm), _ = case
    y = np.zeros((T, D), np.float32)
    gx = np.zeros((T, D), np.float32)
    for r, o in enumerate(got):
        y[o[i]["rows"]] = o[i]["y"]
        gx[o[i]["rows"]] = o[i]["grads"][0]
    grw = sum(got[d * nm][i]["grads"][1] for d in range(nd))
    ws = []
    for j in (2, 3, 4):
        per_m = [sum(got[d * nm + m][i]["grads"][j] for d in range(nd))
                 for m in range(nm)]
        axis = 0 if mode == "ep" else (2 if j < 4 else 1)
        ws.append(np.concatenate(per_m, axis))
    return y, [gx, grw] + ws


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["_".join(map(str, c)) for c in CASES])
def test_sharded_moe_matches_jax_shard_map(results, i):
    job, cases, want, got = results
    y, grads = _assemble(i, cases[i], job, got)
    np.testing.assert_allclose(y, want[f"y{i}"], rtol=0, atol=1e-4)
    for o in got:
        assert abs(o[i]["aux"] - float(want[f"aux{i}"])) < 1e-4
    for j, g in enumerate(grads):
        np.testing.assert_allclose(g, want[f"g{i}_{j}"], rtol=1e-4,
                                   atol=1e-5, err_msg=f"grad {j}")
    # the router's ids away from ties, on every rank's rows
    key = cases[i][2]
    p = np.sort(want[f"probs_{key}"], -1)[:, ::-1]
    clear = (p[:, 0] - p[:, 1] > 1e-6) & (p[:, 1] - p[:, 2] > 1e-6)
    assert clear.mean() > 0.9
    for o in got:
        rows = o[i]["rows"]
        ok = clear[rows]
        np.testing.assert_array_equal(o[i]["eidx"][ok],
                                      want[f"eidx_{key}"][rows][ok])


def test_no_drop_equals_the_global_moe_and_drops_differ(results):
    from repro_torch.models import moe

    job, cases, want, got = results
    import torch
    # the random batch drops nothing on any shard: the global moe_ffn
    for i, case in enumerate(cases):
        if case[2] == "x":
            y, _ = _assemble(i, case, job, got)
            np.testing.assert_allclose(y, want["global"], rtol=0, atol=1e-4)
    # the repeated batch drops pairs on a 2 x 2 shard, per shard
    x = torch.from_numpy(job["x_drop"])
    _, _, eidx = moe.route(x, torch.from_numpy(job["rw"]), K)
    C = moe.capacity(T // 2, E, K)
    drops = [int((~moe.dispatch_plan(eidx[s * 32:(s + 1) * 32], E, C)[2])
                 .sum()) for s in range(2)]
    assert drops[0] > 0, drops
    i = cases.index(("tp", [2, 2], "x_drop"))
    y, _ = _assemble(i, cases[i], job, got)
    glob, _ = moe.moe_ffn(x, *(torch.from_numpy(job[k]) for k in
                               ("rw", "wg", "wu", "wd")), top_k=K)
    assert np.abs(y - glob.numpy()).max() > 1e-3    # not the global drops


def test_sharded_paths_raise_without_a_process_group():
    """No fallback: a mesh of more than one rank with no process group
    makes the dispatches ("sort" too), the LM step and the NequIP step
    raise."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe, nequip, nequip_sharded
    from repro_torch.models import sharding as sh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init

    job = _inputs()
    mesh = Mesh((2, 2), ("data", "model"))
    t = {k: torch.from_numpy(job[k]) for k in ("x", "rw", "wg", "wu", "wd")}
    half = F // 2
    ep_w = (t["wg"][:4], t["wu"][:4], t["wd"][:4])
    tp_w = (t["wg"][..., :half], t["wu"][..., :half], t["wd"][:, :half])
    for fn, w in ((moe.moe_ffn_ep_shardmap, ep_w),
                  (moe.moe_ffn_tp_shardmap, tp_w),
                  (moe.moe_ffn_sort_mesh, ep_w),
                  (moe.moe_ffn_sort_mesh, tp_w)):
        with pytest.raises(RuntimeError, match="process group"):
            fn(t["x"][:32], t["rw"], *w, top_k=K, mesh=mesh)
    cfg = dataclasses.replace(get_config("mixtral-8x7b", "smoke"),
                              moe_impl="tp_shard_map")
    p = tf.init_params(cfg, device="cpu")
    tok = torch.zeros((4, 8), dtype=torch.int32)
    with sh.rules_ctx({}, mesh=mesh):
        pl = sh.shard_tree(p, tf.param_shardings(cfg, mesh))
        with pytest.raises(RuntimeError, match="process group"):
            tf.make_train_step(cfg)(pl, adamw_init(pl),
                                    {"tokens": tok, "labels": tok})
        with pytest.raises(RuntimeError, match="process group"):
            tf.make_prefill_step(cfg)(pl, tok)
    # the default "sort" on a mesh is the global dispatch over the ranks,
    # never the one-device function
    with sh.rules_ctx({"embed_w": None}, mesh=Mesh((2, 1),
                                                   ("data", "model"))):
        with pytest.raises(RuntimeError, match="process group"):
            tf.forward(dataclasses.replace(cfg, moe_impl="sort"), p, tok)
    ncfg = get_config("nequip", "smoke")
    npar = nequip.init_params(ncfg, device="cpu")
    b = {"positions": torch.zeros(8, 3),
         "species": torch.zeros(8, dtype=torch.int32),
         "graph_id": torch.zeros(8, dtype=torch.int32),
         "energy_target": torch.zeros(1),
         "edge_src_sharded": torch.zeros((4, 8), dtype=torch.int32),
         "edge_dst_sharded": torch.zeros((4, 8), dtype=torch.int32),
         "edge_mask_sharded": torch.zeros((4, 8))}
    with pytest.raises(RuntimeError, match="process group"):
        nequip_sharded.forward_sharded(ncfg, npar, b, mesh)
