"""The port's dense LM (repro_torch.models.{layers,attention,transformer})
against the JAX package's at smoke widths, both starting from JAX's
init carried across by `convert.transformer_params_from_numpy`.

Tolerances (float32 on the CPU; matmuls summed in another order by
MKL and XLA): layers, attention, hidden states and prefill/decode logits
rtol 1e-4, atol 1e-5; the loss rtol 1e-5; gradients rtol 1e-3, atol
1e-6. One AdamW step: the step's lr rtol 1e-6, the first moments rtol
1e-3, atol 1e-7 (a tenth of the clipped gradient), and the update
P1 - P0 itself rtol 1e-3 plus 2 ulp of the parameter wherever the two
first moments agree to 1% and stand above 1e-7 (or are both exactly 0):
at least 99% of all entries and half of every leaf's (the key bias's
gradient is near rounding at a third of its entries). Elsewhere a
near-zero gradient may differ in sign, and Adam moves a parameter by
about lr whatever its gradient's size, so the update is held within two
first-step moves there.
"""

import dataclasses

import numpy as np
import pytest
import torch

DENSE = ["qwen2-1.5b", "qwen2.5-32b", "deepseek-67b"]
TOL = dict(rtol=1e-4, atol=1e-5)


def _cfgs(arch, **over):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget

    jc = dataclasses.replace(jget(arch, "smoke"), **over)
    tc = dataclasses.replace(tget(arch, "smoke"), **over)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _params(jc, tc, seed=0):
    import jax

    from repro.models import transformer as jt
    from repro_torch.convert import transformer_params_from_numpy

    jp = jt.init_params(jc, jax.random.key(seed))
    tp = transformer_params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return jp, tp


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": t[:, :S], "labels": t[:, 1:]}


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t.detach() if isinstance(
        t, torch.Tensor) else t, np.float32), np.asarray(j, np.float32),
        **(tol or TOL))


def test_rmsnorm_swiglu_rope_match_jax():
    import jax.numpy as jnp

    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    _close(tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)),
           jl.rmsnorm(jnp.asarray(x), jnp.asarray(g)))
    h = rng.standard_normal((2, 8, 16)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * 0.2
         for s in ((16, 24), (16, 24), (24, 16))]
    _close(tl.swiglu(torch.from_numpy(h), *map(torch.from_numpy, w)),
           jl.swiglu(jnp.asarray(h), *map(jnp.asarray, w)))
    pos = np.tile(np.arange(8, dtype=np.int32) * 37, (2, 1))
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(tl.rope_freqs(16, theta).numpy(),
                                   np.asarray(jl.rope_freqs(16, theta)),
                                   rtol=2e-7, atol=0)
        _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta),
               jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    # bf16 in, bf16 out; computed in float32 inside
    xb = torch.from_numpy(x).bfloat16()
    assert tl.rmsnorm(xb, torch.from_numpy(g)).dtype == torch.bfloat16
    assert tl.apply_rope(xb, torch.from_numpy(pos), 1e6).dtype \
        == torch.bfloat16


@pytest.mark.parametrize("S,q_chunk,window", [(32, 512, None),
                                              (64, 16, 24)],
                         ids=["one_chunk", "scan_window"])
def test_attention_and_its_gradient_match_jax(S, q_chunk, window):
    import jax
    import jax.numpy as jnp

    from repro.models import attention as ja
    from repro_torch.models import attention as ta

    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, S, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    gout = rng.standard_normal((2, S, 4, 16)).astype(np.float32)

    def jf(q, k, v):
        return jnp.sum(ja.attention(q, k, v, window=window, q_chunk=q_chunk)
                       * gout)
    jout = ja.attention(*map(jnp.asarray, (q, k, v)), window=window,
                        q_chunk=q_chunk)
    jg = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tout = ta.attention(*ts, window=window, q_chunk=q_chunk)
    tg = torch.autograd.grad(tout, ts, torch.from_numpy(gout))
    _close(tout, jout)
    for a, b in zip(tg, jg):
        _close(a, b)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_loss_match_jax(arch):
    import jax.numpy as jnp

    from repro.models import transformer as jt
    from repro_torch.models import transformer as tt

    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc)
    b = _tokens(jc, 2, 32)
    jh, _, _ = jt.forward(jc, jp, jnp.asarray(b["tokens"]))
    with torch.no_grad():
        th, _, aux = tt.forward(tc, tp, torch.from_numpy(b["tokens"]))
        tl = tt.lm_loss(tc, th, tp["lm_head"], torch.from_numpy(b["labels"]))
    _close(th, jh)
    assert float(aux) == 0.0
    jl = jt.lm_loss(jc, jh, jp["lm_head"], jnp.asarray(b["labels"]))
    _close(tl, jl, rtol=1e-5)


def test_chunked_loss_equals_one_chunk():
    from repro_torch.models import transformer as tt

    _, tc = _cfgs("qwen2-1.5b")
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 32, tc.d_model, generator=g)
    head = torch.randn(tc.d_model, tc.vocab_size, generator=g) * 0.1
    y = torch.randint(0, tc.vocab_size, (2, 32), generator=g)
    one = tt.lm_loss(tc, h, head, y)
    for chunk in (8, 5):       # 5 does not divide 32: one chunk of S
        got = tt.lm_loss(dataclasses.replace(tc, logits_chunk=chunk), h,
                         head, y)
        torch.testing.assert_close(got, one, rtol=1e-6, atol=0)


def _jax_step(jc, jp, b, schedule=None, count=0):
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as jt
    from repro.optim import adamw_init

    state = dict(adamw_init(jp), count=jnp.int32(count))
    return jax.jit(jt.make_train_step(jc, schedule))(
        jp, state, jax.tree.map(jnp.asarray, b))


def _step_close(tP, tO, tm, jP, jO, jm, p0):
    """Holds one AdamW step of the port to JAX's from the same params p0
    (JAX's tree) and the same zero moments, as the module docstring
    states."""
    import jax

    from repro_torch.configs.base import TrainConfig

    tc = TrainConfig()
    lr = float(jm["lr"])
    _close(tm["lr"], lr, rtol=1e-6, atol=0)
    assert int(tO["count"]) == int(jO["count"])
    n = int(jO["count"])
    # |mhat / (sqrt(vhat) + eps)| of a step from zero moments
    most = (1 - tc.b1) / (1 - tc.b1 ** n) / np.sqrt(
        (1 - tc.b2) / (1 - tc.b2 ** n))
    kept = total = 0
    for a, c, ma, mc, p in zip(_leaves(tP), jax.tree.leaves(jP),
                               _leaves(tO["mu"]), jax.tree.leaves(jO["mu"]),
                               jax.tree.leaves(p0)):
        ma, mc = (np.asarray(x, np.float64) for x in (ma.detach(), mc))
        np.testing.assert_allclose(ma, mc, rtol=1e-3, atol=1e-7)
        p = np.asarray(p, np.float32)
        dt = np.asarray(a.detach(), np.float64) - p
        dj = np.asarray(c, np.float64) - p
        ulp = 2 * np.spacing(np.abs(p) + np.abs(dj).astype(np.float32))
        ok = (((np.abs(ma - mc) <= 1e-2 * np.abs(mc)) & (np.abs(mc) >= 1e-7))
              | ((ma == 0) & (mc == 0)))
        err = np.abs(dt - dj)
        assert (err[ok] <= 1e-3 * np.abs(dj[ok]) + ulp[ok]).all(), \
            float((err[ok] - 1e-3 * np.abs(dj[ok])).max())
        assert (err[~ok] <= 2 * lr * most + ulp[~ok]).all()
        assert ok.mean() >= 0.5, ok.mean()
        kept, total = kept + ok.sum(), total + ok.size
    assert kept >= 0.99 * total, kept / total


def _grads_close(tg, jg):
    import jax

    for a, b in zip(_leaves(tg), jax.tree.leaves(jg)):
        _close(a, b, rtol=1e-3, atol=1e-6)


def _leaves(tree):
    from repro_torch.common.tree import tree_leaves
    return tree_leaves(tree)


def test_one_train_step_matches_jax():
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as jt
    from repro.optim.schedules import make_schedule as jsched
    from repro_torch.models import transformer as tt
    from repro_torch.optim import adamw_init, make_schedule as tsched

    jc, tc = _cfgs("qwen2-1.5b")
    jp, tp = _params(jc, tc)
    b = _tokens(jc, 4, 32)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    (jtot, _), jg = jax.value_and_grad(
        lambda p: (lambda h: (jt.lm_loss(jc, h[0], p["lm_head"],
                                         jnp.asarray(b["labels"])), 0))(
            jt.forward(jc, p, jnp.asarray(b["tokens"]))), has_aux=True)(jp)
    (ttot, tl, _), tg = tt.value_and_grad(tc, tp, tb)
    _close(ttot, jtot, rtol=1e-5)
    _grads_close(tg, jg)
    # step 12 of a warmed-up cosine schedule: lr = sched(count) and the
    # bias corrections of count 13 both enter the update
    sched = ("cosine", 3e-4, 10, 100)
    jP, jO, jm = _jax_step(jc, jp, b, jsched(*sched), count=12)
    state = dict(adamw_init(tp), count=torch.tensor(12, dtype=torch.int32))
    tP, tO, tm = tt.make_train_step(tc, tsched(*sched))(tp, state, tb)
    _close(tm["loss"], jm["loss"], rtol=1e-5)
    _close(tm["grad_norm"], jm["grad_norm"], rtol=1e-4)
    assert 3e-5 < float(jm["lr"]) < 3e-4
    _step_close(tP, tO, tm, jP, jO, jm, jp)
    assert int(tO["count"]) == 13


def test_microbatched_step_matches_jax():
    import jax

    from repro_torch.models import transformer as tt
    from repro_torch.optim import adamw_init

    jc, tc = _cfgs("qwen2-1.5b", microbatch=2)
    jp, tp = _params(jc, tc)
    b = _tokens(jc, 4, 16, seed=3)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jP, jO, jm = _jax_step(jc, jp, b)
    tP, tO, tm = tt.make_train_step(tc)(tp, adamw_init(tp), tb)
    _close(tm["loss"], jm["loss"], rtol=1e-5)
    _close(tm["grad_norm"], jm["grad_norm"], rtol=1e-4)
    _step_close(tP, tO, tm, jP, jO, jm, jp)
    # the accumulated gradients are the mean of the two halves'
    (_, l_all, _), g_all = tt.grads_fn(dataclasses.replace(tc, microbatch=0),
                                       tp, tb)
    (_, l_mb, _), g_mb = tt.grads_fn(tc, tp, tb)
    _close(l_mb, l_all, rtol=1e-5)
    for a, c in zip(_leaves(g_mb), _leaves(g_all)):
        torch.testing.assert_close(a, c, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("window", [None, 12], ids=["full", "swa"])
def test_prefill_and_four_decode_steps_match_jax(window):
    import jax.numpy as jnp

    from repro.models import transformer as jt
    from repro_torch.models import transformer as tt

    jc, tc = _cfgs("qwen2-1.5b", sliding_window=window)
    jp, tp = _params(jc, tc)
    B, S = 2, 16
    toks = _tokens(jc, B, S)["tokens"]
    jl, jcache = jt.make_prefill_step(jc)(jp, jnp.asarray(toks))
    tl, tcache = tt.make_prefill_step(tc)(tp, torch.from_numpy(toks))
    _close(tl, jl)
    for n in ("k", "v"):
        _close(tcache[n], jcache[n])
    # a cache of S + 8 slots (a ring of the window under SWA), the
    # prefill's entries in front
    W = min(S + 8, window) if window else S + 8
    Sp = tcache["k"].shape[2]
    tc_ = tt.init_cache(tc, B, S + 8, device="cpu")
    assert tuple(tc_["k"].shape) == (tc.n_layers, B, W, tc.n_kv_heads, tc.hd)
    jcache = {n: jnp.zeros(tc_[n].shape, jnp.float32).at[:, :, :Sp].set(
        jcache[n]) for n in ("k", "v")}
    for n in ("k", "v"):
        tc_[n][:, :, :Sp] = tcache[n]
    dec_j, dec_t = jt.make_decode_step(jc), tt.make_decode_step(tc)
    tok = np.argmax(np.asarray(jl), 1).astype(np.int32)[:, None]
    for i in range(4):
        pos = Sp + i
        jl, jcache = dec_j(jp, jcache, jnp.asarray(tok), jnp.int32(pos))
        tl, tc_ = dec_t(tp, tc_, torch.from_numpy(tok), pos)
        _close(tl, jl)
        for n in ("k", "v"):
            _close(tc_[n], jcache[n])
        tok = np.argmax(np.asarray(jl), 1).astype(np.int32)[:, None]


def test_templates_counts_and_init_follow_jax():
    import jax

    from repro.configs import get_config as jget
    from repro.models import transformer as jt
    from repro_torch.configs import get_config as tget
    from repro_torch.models import transformer as tt

    for arch in DENSE:
        for variant in ("smoke", "full"):
            jc, tc = jget(arch, variant), tget(arch, variant)
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
            assert tc.param_count() == jc.param_count()
            want = jax.tree.map(lambda s: tuple(s.shape),
                                jt.abstract_params(jc))
            got = {k: ({n: lf.shape for n, lf in v.items()}
                       if isinstance(v, dict) else v.shape)
                   for k, v in tt.param_template(tc).items()}
            assert got == want
    assert tget("qwen2-1.5b").param_count() == 1_777_088_000
    tc = tget("qwen2-1.5b", "smoke")
    p = tt.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert sum(x.numel() for x in _leaves(p)) == tc.param_count()
    assert torch.equal(p["layers"]["ln1"], torch.ones_like(
        p["layers"]["ln1"]))
    assert not p["layers"]["bq"].any()
    std = float(p["layers"]["ffn_wd"].std())
    assert abs(std * tc.d_ff ** 0.5 - 1.0) < 0.05

