"""The sharded LM where the reference's production cells need more than
heads that divide the mesh: query heads that do not divide over the
"model" axis (qwen2-1.5b's 12 heads on 16 ranks, here 6 on 4), and the
KV sequence sharded over "model" (the decode and prefill cells' rule
`seq_kv: ("model",)`, with `batch: None` as long_500k has it), on 4 gloo
ranks against the JAX package's jitted steps on 4 host devices under
the same rules, from JAX's init, and against the port's one-rank steps.
Under the seq_kv rules also a prefill whose length does not split over
"model" (returned whole, as JAX returns it) and its decode into a width
that splits.

Tolerances, those of tests/test_torch_transformer_mesh.py (float32 on
the CPU): the loss within 1e-4 and every param within 5e-4 after one
AdamW step; prefill and decode logits and the caches rtol 1e-4, atol
1e-5. The gradients themselves: one AdamW step moves a weight by about
lr = 3e-4 whatever its gradient's size, so the params' gate alone would
pass a wrong gradient; the global gradient norm is held within 1e-4
relative, and the first moment after the step ((1 - b1) x the clipped
gradient) leaf by leaf within 1e-4 x its largest magnitude.
"""

import json

import numpy as np
import pytest

from _torch_mesh import nest, run_jax, spawn

UNEVEN = dict(dtype="float32", param_dtype="float32", n_heads=6,
              n_kv_heads=2, head_dim=16)
EVEN = dict(dtype="float32", param_dtype="float32", n_heads=4,
            n_kv_heads=2)
SEQ_KV = {"seq_kv": ["model"], "batch": None}
CASES = [
    dict(name="uneven_heads_1x4", arch="qwen2-1.5b", over=UNEVEN,
         mesh=[1, 4], train=True),
    dict(name="uneven_heads_swa_1x4", arch="qwen2-1.5b",
         over=dict(UNEVEN, n_kv_heads=3, sliding_window=12),
         mesh=[1, 4], train=True),
    dict(name="seq_kv_batch_none_1x4", arch="qwen2-1.5b", over=EVEN,
         mesh=[1, 4], rules=SEQ_KV),
    dict(name="seq_kv_uneven_heads_1x4", arch="qwen2-1.5b", over=UNEVEN,
         mesh=[1, 4], rules=SEQ_KV),
    dict(name="seq_kv_batch_data_2x2", arch="qwen2-1.5b", over=EVEN,
         mesh=[2, 2], rules={"seq_kv": ["model"]}),
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
    rules = {k: tuple(v) if isinstance(v, list) else v
             for k, v in (c.get("rules") or {}).items()}
    mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with rules_ctx(rules, mesh=mesh):
        psh = tf.param_shardings(cfg, mesh)
        bsh = named_sharding(mesh, "batch", None)
        if c.get("train"):
            osh = {"mu": psh, "nu": psh, "count": NamedSharding(mesh, P())}
            step = jax.jit(tf.make_train_step(cfg),
                           in_shardings=(psh, osh, {"tokens": bsh,
                                                    "labels": bsh}))
            p2, o2, m = step(params, adamw_init(params), batch)
            for k, v in flat(p2).items():
                out[f"params{i}{k}"] = v
            for k, v in flat(o2["mu"]).items():
                out[f"mu{i}{k}"] = v
            out[f"loss{i}"] = np.asarray(m["loss"])
            out[f"gnorm{i}"] = np.asarray(m["grad_norm"])
        pp = jax.device_put(params, psh)
        logits, cache = jax.jit(tf.make_prefill_step(cfg))(
            pp, jax.device_put(tok, bsh))
        out[f"prefill{i}"] = np.asarray(logits)
        for k, v in cache.items():
            out[f"prefill_cache{i}{k}"] = np.asarray(v)
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
                jnp.asarray(job[f"dec{i}"][:, t:t + 1]), bsh),
                tok.shape[1] + t)
            out[f"decode{i}_{t}"] = np.asarray(lg)
        for k, v in cache.items():
            out[f"cache{i}{k}"] = np.asarray(v)
        if not c.get("rules"):
            continue
        # a prefill of S - 1 positions, which do not split over "model",
        # then decode into a width that splits and one that does not
        odd = tok[:, :-1]
        logits, cache = jax.jit(tf.make_prefill_step(cfg))(
            pp, jax.device_put(odd, bsh))
        out[f"odd_prefill{i}"] = np.asarray(logits)
        out[f"odd_spec{i}"] = np.asarray(json.dumps(
            [[list(e) if isinstance(e, tuple) else e
              for e in cache[k].sharding.spec] for k in ("k", "v")]))
        out[f"odd_shards{i}"] = np.asarray(
            [s.data.shape for s in cache["k"].addressable_shards])
        for k, v in cache.items():
            out[f"odd_prefill_cache{i}{k}"] = np.asarray(v)
        W = tok.shape[1] + n_dec
        csh = tf.cache_shardings(cfg, mesh, tok.shape[0], W)
        cache = {k: jax.device_put(jnp.pad(
            v, ((0, 0), (0, 0), (0, W - v.shape[2]), (0, 0), (0, 0))),
            csh[k]) for k, v in cache.items()}
        for t in range(n_dec):
            lg, cache = dec(pp, cache, jax.device_put(
                jnp.asarray(job[f"dec{i}"][:, t:t + 1]), bsh),
                odd.shape[1] + t)
            out[f"odd_decode{i}_{t}"] = np.asarray(lg)
        for k, v in cache.items():
            out[f"odd_cache{i}{k}"] = np.asarray(v)
        try:
            jax.device_put(jnp.zeros(tf.cache_template(
                cfg, tok.shape[0], W - 1)["k"].shape, jnp.float32),
                tf.cache_shardings(cfg, mesh, tok.shape[0], W - 1)["k"])
            out[f"odd_refusal{i}"] = np.asarray("")
        except ValueError as e:
            out[f"odd_refusal{i}"] = np.asarray(str(e))
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_uneven")
    rng = np.random.default_rng(3)
    job = {"cases": json.dumps(CASES)}
    for i in range(len(CASES)):
        job[f"tokens{i}"] = rng.integers(0, 256, (B, S)).astype(np.int32)
        job[f"dec{i}"] = rng.integers(0, 256, (B, N_DEC)).astype(np.int32)
    jpath, out = str(tmp / "job.npz"), str(tmp / "jax.npz")
    np.savez(jpath, **job)
    run_jax(_JAX.replace("JOB", repr(jpath)).replace("OUT", repr(out)))
    want = dict(np.load(out))
    tjob = {"cases": CASES}
    for i in range(len(CASES)):
        tjob[f"params{i}"] = nest(want, f"init{i}")
        tjob[f"tokens{i}"] = job[f"tokens{i}"]
        tjob[f"dec{i}"] = job[f"dec{i}"]
    return want, spawn("task_lm_rules", tjob, tmp)


TRAIN = [i for i, c in enumerate(CASES) if c.get("train")]


@pytest.mark.parametrize("i", TRAIN, ids=[CASES[i]["name"] for i in TRAIN])
def test_uneven_heads_train_step_matches_jax_and_one_rank(results, i):
    want, got = results
    for o in got:
        assert abs(o[i]["loss"] - float(want[f"loss{i}"])) < 1e-4
    r = got[0][i]
    keys = [k for k in want if k.startswith(f"params{i}")]
    assert len(keys) == len(r["params"])
    worst = max(float(np.abs(r["params"][k[len(f"params{i}"):]]
                             - want[k]).max()) for k in keys)
    assert worst < 5e-4, worst
    assert abs(r["single_loss"] - r["loss"]) < 1e-4
    worst = max(float(np.abs(r["single_params"][k] - r["params"][k]).max())
                for k in r["params"])
    assert worst < 5e-4, worst
    # the gradients: their norm, and each leaf through the first moment
    gn = float(want[f"gnorm{i}"])
    for g in (r["gnorm"], r["single_gnorm"]):
        assert abs(g - gn) <= 1e-4 * gn, (g, gn)
    mu = {k[len(f"mu{i}"):]: v for k, v in want.items()
          if k.startswith(f"mu{i}")}
    assert set(mu) == set(r["mu"]) == set(r["single_mu"])
    for k, w in mu.items():
        scale = float(np.abs(w).max())
        assert scale > 0, k
        for got in (r["mu"][k], r["single_mu"][k]):
            d = float(np.abs(got - w).max())
            assert d <= 1e-4 * scale, (k, d, scale)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_prefill_decode_and_cache_match_jax_and_one_rank(results, i):
    want, got = results
    one = got[0][i]["single"]
    for o in got:
        r, rows = o[i], o[i]["rows"]
        _close(r["prefill"], want[f"prefill{i}"][rows])
        _close(r["prefill"], one["prefill"][rows])
        for t in range(N_DEC):
            _close(r["decode"][t], want[f"decode{i}_{t}"][rows])
            _close(r["decode"][t], one["decode"][t][rows])
        for k in ("k", "v"):
            _close(r["prefill_cache"][k], want[f"prefill_cache{i}{k}"])
            _close(r["cache"][k], want[f"cache{i}{k}"])
            _close(r["cache"][k], one["cache"][k])


SEQ = [i for i, c in enumerate(CASES) if c.get("rules")]


@pytest.mark.parametrize("i", SEQ, ids=[CASES[i]["name"] for i in SEQ])
def test_seq_kv_prefill_refuses_a_length_that_does_not_split(results, i):
    """S - 1 = 31 positions over the "model" ranks (4, or 2 on 2 x 2) do
    not split. The prefill keeps them whole, as JAX's jitted prefill does
    (its output spec splits the batch as the rules do and not the
    sequence: PartitionSpec() with batch None): on every rank JAX's
    logits and the whole sequence of the cache. Decode into S + 4 = 36
    slots, which split, matches JAX's logits and caches and the one-rank
    run's. A width that does not split (35) is refused on both sides: by
    jax.device_put, and by the port's local_shape (ValueError)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models import transformer as tf

    want, got = results
    c = CASES[i]
    nm = c["mesh"][1]
    # JAX's output placement is the port's stated one: the batch as the
    # rules split it, the sequence whole
    cfg = dataclasses.replace(get_config(c["arch"], "smoke"), **c["over"])
    mesh = Mesh(tuple(c["mesh"]), ("data", "model"))
    rules = {k: tuple(v) if isinstance(v, list) else v
             for k, v in c["rules"].items()}
    with sh.rules_ctx(rules, mesh=mesh):
        spec = [list(e) if isinstance(e, tuple) else e for e in
                tf.prefill_cache_shardings(cfg, mesh, B, S - 1)["k"].spec]
    while spec and spec[-1] is None:
        spec.pop()
    assert "model" not in json.dumps(spec)
    assert json.loads(str(want[f"odd_spec{i}"])) == [spec, spec]
    whole = want[f"odd_prefill_cache{i}k"].shape
    assert whole[2] == S - 1 and whole[2] % nm
    nd = c["mesh"][0] if rules.get("batch", ("data",)) else 1
    local = whole[:1] + (whole[1] // nd,) + whole[2:]
    assert all(tuple(s) == local for s in want[f"odd_shards{i}"])
    one = got[0][i]["single_odd"]
    for o in got:
        r, rows = o[i]["odd"], o[i]["rows"]
        # this rank's batch rows, every position of the sequence
        assert r["prefill_local_len"] == S - 1
        _close(r["prefill"], want[f"odd_prefill{i}"][rows])
        _close(r["prefill"], one["prefill"][rows])
        for t in range(N_DEC):
            _close(r["decode"][t], want[f"odd_decode{i}_{t}"][rows])
            _close(r["decode"][t], one["decode"][t][rows])
        for k in ("k", "v"):
            _close(r["prefill_cache"][k], want[f"odd_prefill_cache{i}{k}"])
            _close(r["cache"][k], want[f"odd_cache{i}{k}"])
            _close(r["cache"][k], one["cache"][k])
        assert f"divisible by {nm}" in str(want[f"odd_refusal{i}"])
        assert f"divides by {nm}" in o[i]["odd_refusal"]


def test_the_repairs_take_the_new_layouts():
    """The uneven case's heads do not divide over 4 ranks, and the plan
    of a seq_kv rule holds the sequence axes: the paths above run the
    all-heads layout and the flash-decode combine."""
    from repro_torch.configs import get_config
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen2-1.5b", "smoke"), **UNEVEN)
    assert cfg.n_heads % 4 and (cfg.n_heads * cfg.hd) % 4 == 0
    assert get_config("qwen2-1.5b").n_heads % 16
