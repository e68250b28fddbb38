"""The port's owner-sharded NequIP (repro_torch.models.nequip_sharded)
on 4 gloo ranks against the JAX package's inside shard_map on 4 host
devices, on the same meshes: 2 x 2 over ("data", "model"), 1 x 4 and a
(4,) data mesh, from JAX's init.

  * shard_edges_by_owner byte for byte JAX's (masked edges, node counts
    that do not divide), with the covering and ownership checks of
    tests/test_nequip_sharded.py
  * forward_sharded's energies against JAX's at rtol 2e-4, atol 2e-5 (the
    reference's own test), and against the port's one-device forward
  * one sharded train step: the loss rtol 1e-5, the gradient norm rtol
    1e-4 and every param within 5e-4 of JAX's make_train_step_sharded
"""

import json

import numpy as np
import pytest

from _torch_mesh import nest, run_jax, spawn

N, E = 64, 300
CASES = [dict(shape=[2, 2], names=["data", "model"], axes=["data", "model"]),
         dict(shape=[1, 4], names=["data", "model"], axes=["data", "model"]),
         dict(shape=[4], names=["data"], axes=["data"])]


@pytest.mark.parametrize("n_nodes,n_edges,n_shards,masked", [
    (100, 400, 8, False), (64, 300, 4, False), (61, 500, 4, True),
    (10, 3, 4, True)])
def test_shard_edges_by_owner_is_byte_for_byte_jax(n_nodes, n_edges,
                                                   n_shards, masked):
    from repro.models.nequip_sharded import shard_edges_by_owner as jax_fn
    from repro_torch.models.nequip_sharded import shard_edges_by_owner

    rng = np.random.default_rng(n_nodes)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    mask = (rng.random(n_edges) > 0.3).astype(np.float32) if masked \
        else np.ones(n_edges)
    got = shard_edges_by_owner(src, dst, mask, n_nodes, n_shards)
    want = jax_fn(src, dst, mask, n_nodes, n_shards)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    es, ed, em = got
    live = mask > 0
    kept = [(int(s), int(d)) for sh in range(n_shards)
            for s, d, m in zip(es[sh], ed[sh], em[sh]) if m > 0]
    assert sorted(kept) == sorted(zip(src[live].tolist(),
                                      dst[live].tolist()))
    n_loc = -(-n_nodes // n_shards)
    for sh in range(n_shards):
        d = ed[sh][em[sh] > 0]
        assert ((d // n_loc) == sh).all()
    assert es.shape[1] % 8 == 0 and es.shape[1] >= 8


_JAX = r"""
import json, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import nequip as nq
from repro.models import nequip_sharded as nqs
from repro.optim import adamw_init
job = dict(np.load(JOB))
cases = json.loads(str(job["cases"]))
cfg = get_config("nequip", "smoke")
params = nq.init_params(cfg, jax.random.key(0))
flat = lambda t: {jax.tree_util.keystr(p): np.asarray(x)
                  for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}
out = {"init" + k: v for k, v in flat(params).items()}
base = {k: jnp.asarray(job[k]) for k in
        ("positions", "species", "graph_id", "energy_target")}
for i, c in enumerate(cases):
    mesh = jax.make_mesh(tuple(c["shape"]), tuple(c["names"]),
        axis_types=(jax.sharding.AxisType.Auto,) * len(c["names"]))
    axes = tuple(c["axes"])
    n = int(np.prod(c["shape"]))
    es, ed, em = nqs.shard_edges_by_owner(job["src"], job["dst"],
                                          job["mask"], len(job["species"]), n)
    b = dict(base, edge_src_sharded=jnp.asarray(es),
             edge_dst_sharded=jnp.asarray(ed),
             edge_mask_sharded=jnp.asarray(em))
    out[f"e{i}"] = np.asarray(jax.jit(
        lambda p, b: nqs.forward_sharded(cfg, p, b, mesh, axes))(params, b))
    step = jax.jit(nqs.make_train_step_sharded(cfg, mesh, axes))
    p2, _, m = step(params, adamw_init(params), b)
    out.update({f"p{i}" + k: v for k, v in flat(p2).items()})
    out[f"loss{i}"], out[f"gn{i}"] = np.asarray(m["loss"]), np.asarray(
        m["grad_norm"])
    out[f"es{i}"], out[f"ed{i}"], out[f"em{i}"] = es, ed, em
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nequip_mesh")
    rng = np.random.default_rng(0)
    job = dict(positions=(rng.standard_normal((N, 3)) * 2).astype(np.float32),
               species=rng.integers(0, 8, N).astype(np.int32),
               src=rng.integers(0, N, E).astype(np.int32),
               dst=rng.integers(0, N, E).astype(np.int32),
               mask=(rng.random(E) > 0.1).astype(np.float32),
               graph_id=(np.arange(N) >= 40).astype(np.int32),
               energy_target=np.asarray([1.5, -2.0], np.float32))
    jpath, out = str(tmp / "job.npz"), str(tmp / "jax.npz")
    np.savez(jpath, cases=json.dumps(CASES), **job)
    run_jax(_JAX.replace("JOB", repr(jpath)).replace("OUT", repr(out)))
    want = dict(np.load(out))
    tjob = {"cases": CASES, "params": nest(want, "init"),
            "batch": {k: job[k] for k in ("positions", "species",
                                          "graph_id", "energy_target")}}
    for i in range(len(CASES)):
        tjob[f"edges{i}"] = {"edge_src_sharded": want[f"es{i}"],
                             "edge_dst_sharded": want[f"ed{i}"],
                             "edge_mask_sharded": want[f"em{i}"]}
    got = spawn("task_nequip", tjob, tmp)
    return job, want, got


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["2x2", "1x4", "data4"])
def test_forward_sharded_matches_jax(results, i):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import nequip_params_from_numpy
    from repro_torch.models import nequip

    job, want, got = results
    for o in got:
        np.testing.assert_allclose(o[i]["energy"], want[f"e{i}"], rtol=2e-4,
                                   atol=2e-5)
    cfg = get_config("nequip", "smoke")
    p = nequip_params_from_numpy(cfg, nest(want, "init"), device="cpu")
    b = {k: torch.from_numpy(v) for k, v in job.items() if k not in
         ("src", "dst", "mask")}
    b.update(edge_src=torch.from_numpy(job["src"]),
             edge_dst=torch.from_numpy(job["dst"]),
             edge_mask=torch.from_numpy(job["mask"]))
    e1 = nequip.forward(cfg, p, b).numpy()
    np.testing.assert_allclose(got[0][i]["energy"], e1, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["2x2", "1x4", "data4"])
def test_one_sharded_train_step_matches_jax(results, i):
    _, want, got = results
    for o in got:
        np.testing.assert_allclose(o[i]["loss"], want[f"loss{i}"],
                                   rtol=1e-5)
        np.testing.assert_allclose(o[i]["gnorm"], want[f"gn{i}"], rtol=1e-4)
        for k, v in o[i]["params"].items():
            assert np.abs(v - want[f"p{i}" + k]).max() < 5e-4, k
    # the ranks hold the same params after the step
    for o in got[1:]:
        for k, v in o[i]["params"].items():
            assert v.tobytes() == got[0][i]["params"][k].tobytes(), k
