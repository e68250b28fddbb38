"""The port's MoE LMs (mixtral-8x7b and arctic-480b through
repro_torch.models.transformer and models/moe.py) against the JAX
package's at `smoke()` widths, both from JAX's init carried across by
`convert.transformer_params_from_numpy`.

Tolerances are the dense LM test's (tests/test_torch_transformer.py):
hidden states and prefill/decode logits rtol 1e-4, atol 1e-5; the loss
and the aux loss rtol 1e-5; gradients rtol 1e-3, atol 1e-6; one AdamW
step's update as `_step_close` holds it. The smoke batches route with
top-2 and 2nd/3rd probability gaps far above the float32 rounding.
"""

import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest
import torch

from test_torch_transformer import (_close, _grads_close, _jax_step,
                                    _leaves, _step_close, _tokens)

MOE = ["mixtral-8x7b", "arctic-480b"]


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


@pytest.mark.parametrize("arch", MOE)
def test_forward_loss_and_aux_match_jax(arch):
    import jax.numpy as jnp

    from repro.models import transformer as jt
    from repro_torch.models import transformer as tt

    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc)
    b = _tokens(jc, 2, 32)
    jh, _, jaux = jt.forward(jc, jp, jnp.asarray(b["tokens"]))
    with torch.no_grad():
        th, _, taux = tt.forward(tc, tp, torch.from_numpy(b["tokens"]))
        tl = tt.lm_loss(tc, th, tp["lm_head"], torch.from_numpy(b["labels"]))
    _close(th, jh)
    _close(taux, jaux, rtol=1e-5)
    assert float(taux) > 1.0        # E * sum(me * ce) is about K
    _close(tl, jt.lm_loss(jc, jh, jp["lm_head"], jnp.asarray(b["labels"])),
           rtol=1e-5)
    # the arctic layer adds the dense SwiGLU beside the experts
    assert ("ffn_wg" in tp["layers"]) == tc.dense_residual


@pytest.mark.parametrize("arch", MOE)
def test_one_train_step_matches_jax(arch):
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as jt
    from repro.optim.schedules import make_schedule as jsched
    from repro_torch.models import transformer as tt
    from repro_torch.optim import adamw_init, make_schedule as tsched

    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc)
    b = _tokens(jc, 4, 32, seed=1)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}

    def jloss(p):
        h, _, aux = jt.forward(jc, p, jnp.asarray(b["tokens"]))
        return jt.lm_loss(jc, h, p["lm_head"], jnp.asarray(b["labels"])) \
            + 0.01 * aux
    jtot, jg = jax.value_and_grad(jloss)(jp)
    (ttot, _, taux), tg = tt.value_and_grad(tc, tp, tb)
    _close(ttot, jtot, rtol=1e-5)
    _grads_close(tg, jg)
    assert float(tg["layers"]["router"].abs().max()) > 0
    sched = ("cosine", 3e-4, 10, 100)
    jP, jO, jm = _jax_step(jc, jp, b, jsched(*sched), count=12)
    state = dict(adamw_init(tp), count=torch.tensor(12, dtype=torch.int32))
    tP, tO, tm = tt.make_train_step(tc, tsched(*sched))(tp, state, tb)
    _close(tm["loss"], jm["loss"], rtol=1e-5)
    _close(tm["aux_loss"], jm["aux_loss"], rtol=1e-5)
    _close(tm["grad_norm"], jm["grad_norm"], rtol=1e-4)
    _step_close(tP, tO, tm, jP, jO, jm, jp)


def test_microbatched_step_matches_jax():
    from repro_torch.models import transformer as tt
    from repro_torch.optim import adamw_init

    jc, tc = _cfgs("mixtral-8x7b", microbatch=2)
    jp, tp = _params(jc, tc)
    b = _tokens(jc, 4, 16, seed=3)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jP, jO, jm = _jax_step(jc, jp, b)
    tP, tO, tm = tt.make_train_step(tc)(tp, adamw_init(tp), tb)
    _close(tm["loss"], jm["loss"], rtol=1e-5)
    # the aux is the mean of the microbatches' (each routes its own T)
    _close(tm["aux_loss"], jm["aux_loss"], rtol=1e-5)
    _close(tm["grad_norm"], jm["grad_norm"], rtol=1e-4)
    _step_close(tP, tO, tm, jP, jO, jm, jp)
    (_, _, a0), _ = tt.value_and_grad(
        tc, tp, {k: v[:2] for k, v in tb.items()})
    (_, _, a1), _ = tt.value_and_grad(
        tc, tp, {k: v[2:] for k, v in tb.items()})
    torch.testing.assert_close(tm["aux_loss"], (a0 + a1) / 2, rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_four_decode_steps_match_jax(arch):
    """mixtral's window 16 makes the decode cache a ring; the decode
    step's MoE routes the batch's B tokens."""
    import jax.numpy as jnp

    from repro.models import transformer as jt
    from repro_torch.models import transformer as tt

    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc)
    B, S = 2, 24
    toks = _tokens(jc, B, S)["tokens"]
    jl, jcache = jt.make_prefill_step(jc)(jp, jnp.asarray(toks))
    tl, tcache = tt.make_prefill_step(tc)(tp, torch.from_numpy(toks))
    _close(tl, jl)
    for n in ("k", "v"):
        _close(tcache[n], jcache[n])
    W = min(S + 8, tc.sliding_window) if tc.sliding_window else S + 8
    Sp = tcache["k"].shape[2]
    tcc = tt.init_cache(tc, B, S + 8, device="cpu")
    assert tcc["k"].shape[2] == W
    jcache = {n: jnp.zeros(tcc[n].shape, jnp.float32).at[:, :, :Sp].set(
        jcache[n]) for n in ("k", "v")}
    for n in ("k", "v"):
        tcc[n][:, :, :Sp] = tcache[n]
    dec_j, dec_t = jt.make_decode_step(jc), tt.make_decode_step(tc)
    tok = np.argmax(np.asarray(jl), 1).astype(np.int32)[:, None]
    for i in range(4):
        pos = S + i
        jl, jcache = dec_j(jp, jcache, jnp.asarray(tok), jnp.int32(pos))
        tl, tcc = dec_t(tp, tcc, torch.from_numpy(tok), pos)
        _close(tl, jl)
        for n in ("k", "v"):
            _close(tcc[n], jcache[n])
        tok = np.argmax(np.asarray(jl), 1).astype(np.int32)[:, None]


def test_full_templates_and_param_counts_follow_jax():
    import jax

    from repro.configs import get_config as jget
    from repro.models import transformer as jt
    from repro_torch.configs import get_config as tget
    from repro_torch.models import transformer as tt

    for arch in MOE:
        for variant in ("smoke", "full"):
            jc, tc = jget(arch, variant), tget(arch, variant)
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
            assert tc.param_count() == jc.param_count()
            assert tc.active_param_count() == jc.active_param_count()
            want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                                jt.abstract_params(jc))
            got = {k: ({n: (lf.shape, lf.dtype) for n, lf in v.items()}
                       if isinstance(v, dict) else (v.shape, v.dtype))
                   for k, v in tt.param_template(tc).items()}
            assert got == want
    assert tget("mixtral-8x7b").param_count() == 46_702_792_704
    one = dataclasses.replace(tget("mixtral-8x7b"), n_layers=1)
    assert one.param_count() == 1_713_418_240
    assert dataclasses.replace(tget("arctic-480b"), n_layers=1) \
        .param_count() == 14_069_945_344
    tc = tget("arctic-480b", "smoke")
    p = tt.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert sum(x.numel() for x in _leaves(p)) == tc.param_count()
    std = float(p["layers"]["moe_wd"].std())
    assert abs(std * tc.moe_d_ff ** 0.5 - 1.0) < 0.05


def test_train_cli_on_mixtral_smoke_recovers_from_a_failure(tmp_path):
    from repro_torch.launch import train as ttrain

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ttrain.main(["--arch", "mixtral-8x7b", "--variant", "smoke",
                          "--steps", "6", "--batch", "4", "--seq", "32",
                          "--ckpt-every", "3", "--fail-at", "4",
                          "--ckpt-dir", str(tmp_path / "ck"),
                          "--device", "cpu"])
    assert rc == 0
    done = re.search(r"done: steps=(\d+) restarts=(\d+) loss (\S+) -> (\S+)",
                     out.getvalue())
    assert done and done.group(1, 2) == ("7", "1")   # 0-3, then 3-5
    assert np.isfinite(float(done.group(3))) and np.isfinite(
        float(done.group(4)))
