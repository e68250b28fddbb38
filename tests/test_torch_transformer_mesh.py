"""The port's sharded LM steps (repro_torch.models.transformer under an
installed mesh: tensor parallelism over "model", the batch and FSDP over
"data", vocab-parallel embedding and loss, the EP/TP MoE) on 4 gloo
ranks against the JAX package's jitted steps with its param and batch
shardings on 4 host devices, on the same meshes, from JAX's init.

Tolerances (float32 on the CPU), those of tests/test_distributed.py:
the loss within 1e-4, every param within 5e-4 after one AdamW step
(the gradients clipped by the global norm: grad_clip 1.0 and a norm
above it here), the first moments within 5e-5 and the gradient norm
rtol 1e-4; prefill and decode logits rtol 1e-4, atol 1e-5. The dense
step is also held to the port's one-rank step at the same tolerances.
The MoE steps here are the shard_map paths, each data shard's tokens
routed at its own capacity, so they are held only to JAX's sharded
step; the default "sort" (one global capacity) is also held to the
one-rank step in tests/test_torch_moe_sort_mesh.py, and every path at a
config's microbatch in tests/test_torch_mesh_microbatch.py.
"""

import json

import numpy as np
import pytest

from _torch_mesh import nest, run_jax, spawn

SMALL_HEADS = dict(dtype="float32", param_dtype="float32", n_heads=4,
                   n_kv_heads=2)
CASES = [
    dict(arch="qwen2-1.5b", over=SMALL_HEADS, mesh=[2, 2], single=True,
         decode=True),
    dict(arch="qwen2-1.5b", over=SMALL_HEADS, mesh=[1, 4], single=True,
         decode=True),
    dict(arch="qwen2-1.5b", over=dict(SMALL_HEADS, sliding_window=12),
         mesh=[4, 1], single=True, decode=True),
    dict(arch="mixtral-8x7b", over=dict(moe_impl="tp_shard_map"),
         mesh=[2, 2], decode=True),
    dict(arch="arctic-480b", over=dict(n_experts=16,
                                       moe_impl="ep_shard_map"),
         mesh=[2, 2], decode=True),
    dict(arch="arctic-480b", over=dict(n_experts=16,
                                       moe_impl="ep_shard_map"),
         mesh=[1, 4]),
]
B, S, N_DEC = 8, 32, 4

_JAX = r"""
import dataclasses, json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import transformer as tf
from repro.models.sharding import rules_ctx, named_sharding
from repro.optim import adamw_init
job = dict(np.load(JOB))
cases = json.loads(str(job["cases"]))
flat = lambda t: {jax.tree_util.keystr(p): np.asarray(x)
                  for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}
out = {}
for i, c in enumerate(cases):
    cfg = dataclasses.replace(get_config(c["arch"], "smoke"), **c["over"])
    params = tf.init_params(cfg, jax.random.key(0))
    for k, v in flat(params).items():
        out[f"init{i}{k}"] = v
    tok = jnp.asarray(job[f"tokens{i}"])
    batch = {"tokens": tok, "labels": tok}
    mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with rules_ctx({}, mesh=mesh):
        psh = tf.param_shardings(cfg, mesh)
        osh = {"mu": psh, "nu": psh, "count": NamedSharding(mesh, P())}
        bsh = {k: named_sharding(mesh, "batch", None) for k in batch}
        step = jax.jit(tf.make_train_step(cfg), in_shardings=(psh, osh, bsh))
        p2, o2, m = step(params, adamw_init(params), batch)
        for k, v in flat(p2).items():
            out[f"params{i}{k}"] = v
        for k, v in flat(o2["mu"]).items():
            out[f"mu{i}{k}"] = v
        for k in ("loss", "aux_loss", "grad_norm"):
            out[f"{k}{i}"] = np.asarray(m[k])
        if c.get("decode"):
            bs = named_sharding(mesh, "batch", None)
            pp = jax.device_put(params, psh)
            logits, cache = jax.jit(tf.make_prefill_step(cfg))(
                pp, jax.device_put(tok, bs))
            out[f"prefill{i}"] = np.asarray(logits)
            n_dec = job[f"dec{i}"].shape[1]
            csh = tf.cache_shardings(cfg, mesh, tok.shape[0],
                                     tok.shape[1] + n_dec)
            W = tf.cache_template(cfg, tok.shape[0],
                                  tok.shape[1] + n_dec)["k"].shape[2]
            cache = {k: jax.device_put(jnp.pad(
                v, ((0, 0), (0, 0), (0, W - v.shape[2]), (0, 0), (0, 0))),
                csh[k]) for k, v in cache.items()}
            dec = jax.jit(tf.make_decode_step(cfg))
            for t in range(n_dec):
                lg, cache = dec(pp, cache, jax.device_put(
                    jnp.asarray(job[f"dec{i}"][:, t:t + 1]), bs),
                    tok.shape[1] + t)
                out[f"decode{i}_{t}"] = np.asarray(lg)
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_mesh")
    rng = np.random.default_rng(0)
    job = {"cases": json.dumps(CASES)}
    for i, c in enumerate(CASES):
        vocab = 256
        job[f"tokens{i}"] = rng.integers(0, vocab, (B, S)).astype(np.int32)
        job[f"dec{i}"] = rng.integers(0, vocab, (B, N_DEC)).astype(np.int32)
    jpath, out = str(tmp / "job.npz"), str(tmp / "jax.npz")
    np.savez(jpath, **job)
    run_jax(_JAX.replace("JOB", repr(jpath)).replace("OUT", repr(out)))
    want = dict(np.load(out))
    tjob = {"cases": CASES}
    for i in range(len(CASES)):
        tjob[f"params{i}"] = nest(want, f"init{i}")
        tjob[f"tokens{i}"] = job[f"tokens{i}"]
        tjob[f"dec{i}"] = job[f"dec{i}"]
    got = spawn("task_lm", tjob, tmp)
    return want, got


def _ids(c):
    return f"{c['arch']}_{c['mesh'][0]}x{c['mesh'][1]}"


def _params_close(got, want, prefix, tol):
    keys = [k for k in want if k.startswith(prefix)]
    assert len(keys) == len(got)
    worst = max(float(np.abs(got[k[len(prefix):]] - want[k]).max())
                for k in keys)
    assert worst < tol, (prefix, worst)
    return worst


@pytest.mark.parametrize("i", range(len(CASES)), ids=[_ids(c) for c in CASES])
def test_sharded_train_step_matches_jax(results, i):
    want, got = results
    for o in got:            # every rank reports the same metrics
        r = o[i]
        assert abs(r["loss"] - float(want[f"loss{i}"])) < 1e-4
        assert abs(r["aux"] - float(want[f"aux_loss{i}"])) < 1e-4
        np.testing.assert_allclose(r["gnorm"], want[f"grad_norm{i}"],
                                   rtol=1e-4)
    r = got[0][i]
    _params_close(r["params"], want, f"params{i}", 5e-4)
    _params_close(r["mu"], want, f"mu{i}", 5e-5)
    if CASES[i].get("single"):
        # the dense step on the mesh is the one-rank step
        assert abs(r["single_loss"] - r["loss"]) < 1e-4
        np.testing.assert_allclose(r["single_gnorm"], r["gnorm"], rtol=1e-4)
        worst = max(float(np.abs(r["single_params"][k] - r["params"][k])
                          .max()) for k in r["params"])
        assert worst < 5e-4, worst


def test_the_clip_uses_the_global_norm(results):
    """Every case's norm is above grad_clip (1.0), so the step is clipped
    to norm 1: the first moments (0.1 x the clipped gradient, held to
    JAX's above) have norm 0.1 over all the ranks' slices together."""
    want, got = results
    from repro_torch.configs.base import TrainConfig
    assert TrainConfig().grad_clip == 1.0
    for i in range(len(CASES)):
        assert float(want[f"grad_norm{i}"]) > 1.5
        mu = got[0][i]["mu"]
        norm = np.sqrt(sum(float(np.sum(np.square(m, dtype=np.float64)))
                           for m in mu.values()))
        np.testing.assert_allclose(norm, 0.1, rtol=1e-3)


@pytest.mark.parametrize("i", [i for i, c in enumerate(CASES)
                               if c.get("decode")],
                         ids=[_ids(c) for c in CASES if c.get("decode")])
def test_prefill_and_decode_on_the_mesh_match_jax(results, i):
    want, got = results
    for o in got:
        r = o[i]
        rows = r["rows"]
        np.testing.assert_allclose(r["prefill"], want[f"prefill{i}"][rows],
                                   rtol=1e-4, atol=1e-5)
        for t in range(N_DEC):
            np.testing.assert_allclose(r["decode"][t],
                                       want[f"decode{i}_{t}"][rows],
                                       rtol=1e-4, atol=1e-5)
