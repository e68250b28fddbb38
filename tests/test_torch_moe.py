"""The port's MoE layer (repro_torch.models.moe) against the JAX
package's `repro.models.moe.moe_ffn` (its no-mesh dispatch) at small
widths, inputs from numpy seeds.

Tolerances (float32 on the CPU; the experts' matmuls summed in another
order by MKL and XLA): outputs rtol 1e-5, atol 1e-6; the aux loss rtol
1e-6; gradients rtol 1e-4, atol 1e-6. The routing (expert ids, kept and
dropped pairs) is compared exactly. Inputs tie exactly where a test
says so; elsewhere the top-2 and 2nd/3rd probability gaps are checked
to exceed 1e-6, so the routing cannot flip on a rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import moe as jm
from repro_torch.models import moe as tm

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _inputs(T=64, d=32, f=16, E=8, seed=0, dup=False):
    """x (T, d) and the weights; with dup, every other row is row 0, so
    half the tokens route alike and overflow their experts."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, d)) * 0.5).astype(np.float32)
    if dup:
        x[1::2] = x[0]
    rw = (rng.standard_normal((d, E)) * 0.3).astype(np.float32)
    wg = (rng.standard_normal((E, d, f)) * 0.2).astype(np.float32)
    wu = (rng.standard_normal((E, d, f)) * 0.2).astype(np.float32)
    wd = (rng.standard_normal((E, f, d)) * 0.2).astype(np.float32)
    return x, rw, wg, wu, wd


def _jax_route(x, rw, K):
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(rw), axis=-1)
    return np.asarray(probs), np.asarray(jax.lax.top_k(probs, K)[1])


def _gaps_ok(probs, K):
    s = -np.sort(-probs, axis=-1)
    return (s[:, K - 1] - s[:, K] > 1e-6).all() and \
        (s[:, 0] - s[:, 1] > 1e-6).all()


def _numpy_kept(eidx, E, C):
    """The (token, k) pairs an expert keeps, by a loop in (token, k)
    order: the first C pairs routed to each expert."""
    seen = np.zeros(E, int)
    kept = np.zeros(eidx.shape, bool)
    for t in range(eidx.shape[0]):
        for k in range(eidx.shape[1]):
            e = eidx[t, k]
            kept[t, k] = seen[e] < C
            seen[e] += 1
    return kept


def test_capacity_matches_jax_over_a_grid():
    for T in (1, 7, 8, 64, 128, 1000, 1024, 4096):
        for E in (4, 8, 16, 128):
            for K in (1, 2):
                assert tm.capacity(T, E, K) == jm.capacity(T, E, K)
    # the card phases' shapes: mixtral's B 2 x S 64 and B 8 x S 128,
    # arctic's prefill, a decode step of B 8
    assert [tm.capacity(T, E, 2) for T, E in
            ((128, 8), (1024, 8), (1024, 128), (8, 8))] == [40, 320, 24, 8]
    assert tm.CAPACITY_FACTOR == jm.CAPACITY_FACTOR


@pytest.mark.parametrize("dup", [False, True], ids=["no_drops", "drops"])
def test_moe_ffn_matches_jax(dup):
    x, rw, wg, wu, wd = _inputs(dup=dup)
    T, E, K = x.shape[0], rw.shape[1], 2
    probs, eidx = _jax_route(x, rw, K)
    assert _gaps_ok(probs, K)
    C = tm.capacity(T, E, K)
    kept = _numpy_kept(eidx, E, C)
    assert (not kept.all()) == dup
    jo, ja = jm.moe_ffn(*map(jnp.asarray, (x, rw, wg, wu, wd)), top_k=K,
                        ep=False)
    to, ta = tm.moe_ffn(*map(torch.from_numpy, (x, rw, wg, wu, wd)),
                        top_k=K)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    # the port's routing and its plan keep exactly the loop's pairs
    _, _, teidx = tm.route(torch.from_numpy(x), torch.from_numpy(rw), K)
    np.testing.assert_array_equal(teidx.numpy(), eidx)
    sort_idx, dest, valid, token_id = tm.dispatch_plan(teidx, E, C)
    got = np.zeros(T * K, bool)
    got[sort_idx.numpy()] = valid.numpy()
    np.testing.assert_array_equal(got.reshape(T, K), kept)
    np.testing.assert_array_equal(token_id.numpy(), sort_idx.numpy() // K)
    assert (dest[~valid] == E * C).all() and \
        len(set(dest[valid].tolist())) == int(valid.sum())


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_offset_plan_keeps_a_ranks_share_of_the_global_plan(n_ranks):
    """dispatch_plan with each expert's pairs on earlier ranks as offset
    keeps, on every rank's slice of the tokens, exactly the pairs the
    loop over the whole batch keeps; an all-zero offset is bitwise no
    offset; a rank's kept slots, min(cap, its tokens) an expert, are
    distinct and in range."""
    T, E, K = 64, 8, 2
    x, rw, *_ = _inputs(T=T, E=E, seed=3, dup=True)
    _, eidx = _jax_route(x, rw, K)
    C = jm.capacity(T, E, K)
    kept = _numpy_kept(eidx, E, C)
    assert not kept.all()
    teidx = torch.from_numpy(np.array(eidx)).long()
    for a, b in zip(tm.dispatch_plan(teidx, E, C),
                    tm.dispatch_plan(teidx, E, C, torch.zeros(E).long())):
        assert torch.equal(a, b)
    T_l = T // n_ranks
    slots = min(C, T_l)
    offset = torch.zeros(E, dtype=torch.long)
    for r in range(n_ranks):
        part = teidx[r * T_l:(r + 1) * T_l]
        sort_idx, dest, valid, _ = tm.dispatch_plan(part, E, C, offset,
                                                    slots)
        got = np.zeros(T_l * K, bool)
        got[sort_idx.numpy()] = valid.numpy()
        np.testing.assert_array_equal(got.reshape(T_l, K),
                                      kept[r * T_l:(r + 1) * T_l])
        d = dest[valid]
        assert len(set(d.tolist())) == len(d)
        # each kept pair in its expert's block of slots
        e = part.reshape(-1)[sort_idx][valid]
        assert torch.equal(d // slots, e)
        assert (dest[~valid] == E * slots).all()
        offset = offset + tm.expert_counts(part.reshape(-1), E)


def test_tied_router_logits_take_the_lower_expert():
    """Router columns equal in pairs: every token's probabilities tie
    exactly, expert 2i with 2i + 1, and lax.top_k takes the lower index
    of each tie."""
    x, rw, wg, wu, wd = _inputs(T=32, E=8, seed=3)
    rw[:, 1::2] = rw[:, 0::2]
    probs, eidx = _jax_route(x, rw, 2)
    assert (probs[:, 0::2] == probs[:, 1::2]).all()
    assert (eidx[:, 0] % 2 == 0).all()
    assert (eidx[:, 1] == eidx[:, 0] + 1).all()
    _, gate, teidx = tm.route(torch.from_numpy(x), torch.from_numpy(rw), 2)
    np.testing.assert_array_equal(teidx.numpy(), eidx)
    np.testing.assert_allclose(gate.numpy(), 0.5, rtol=1e-6)
    jo, ja = jm.moe_ffn(*map(jnp.asarray, (x, rw, wg, wu, wd)), top_k=2,
                        ep=False)
    to, ta = tm.moe_ffn(*map(torch.from_numpy, (x, rw, wg, wu, wd)),
                        top_k=2)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


@pytest.mark.parametrize("dup", [False, True], ids=["no_drops", "drops"])
def test_moe_gradients_match_jax(dup):
    x, rw, wg, wu, wd = _inputs(dup=dup, seed=1)
    gout = np.random.default_rng(9).standard_normal(x.shape) \
        .astype(np.float32)

    def jf(*a):
        out, aux = jm.moe_ffn(*a, top_k=2, ep=False)
        return jnp.sum(out * gout) + 0.01 * aux
    jg = jax.grad(jf, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, rw, wg, wu, wd)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, rw, wg, wu, wd)]
    out, aux = tm.moe_ffn(*ts, top_k=2)
    tg = torch.autograd.grad(torch.sum(out * torch.from_numpy(gout))
                             + 0.01 * aux, ts)
    for name, a, b in zip(("x", "router", "w_gate", "w_up", "w_down"), tg,
                          jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=name)


def test_aux_loss_is_switch_load_balance():
    """E * sum_e mean_prob_e * load_e, load_e the mean count of expert e
    among each token's top-k; a uniform router gives exactly K."""
    x, rw, wg, wu, wd = _inputs(seed=2)
    probs, eidx = _jax_route(x, rw, 2)
    E = rw.shape[1]
    load = np.stack([(eidx == e).sum(1) for e in range(E)], 1).mean(0)
    want = E * np.sum(probs.mean(0) * load)
    _, aux = tm.moe_ffn(*map(torch.from_numpy, (x, rw, wg, wu, wd)),
                        top_k=2)
    np.testing.assert_allclose(float(aux), want, rtol=1e-5)
    # a zero router: every probability 1/E, the top-2 experts 0 and 1
    _, aux0 = tm.moe_ffn(*map(torch.from_numpy, (x, 0 * rw, wg, wu, wd)),
                         top_k=2)
    np.testing.assert_allclose(float(aux0), 2.0, rtol=1e-6)


@pytest.mark.parametrize("K", [1, 2])
def test_top1_and_top2_match_jax_and_wider_is_refused(K):
    x, rw, wg, wu, wd = _inputs(T=40, E=4, seed=5)
    jo, ja = jm.moe_ffn(*map(jnp.asarray, (x, rw, wg, wu, wd)), top_k=K,
                        ep=False)
    to, ta = tm.moe_ffn(*map(torch.from_numpy, (x, rw, wg, wu, wd)),
                        top_k=K)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    with pytest.raises(ValueError, match="top_k"):
        tm.moe_ffn(*map(torch.from_numpy, (x, rw, wg, wu, wd)), top_k=K + 2)


def test_bfloat16_compute_matches_jax():
    """x and the weights in bfloat16 (the card's train compute): the
    logits and experts in bf16, softmax and silu in float32. Tolerance
    3 bf16 ulps of the output's scale."""
    x, rw, wg, wu, wd = _inputs(seed=6)
    args = [a.astype(jnp.bfloat16) for a in (x, rw, wg, wu, wd)]
    jo, ja = jm.moe_ffn(*map(jnp.asarray, args), top_k=2, ep=False)
    targs = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
             for a in args]
    to, ta = tm.moe_ffn(*targs, top_k=2)
    assert to.dtype == torch.bfloat16
    jo = np.asarray(jo, np.float32)
    np.testing.assert_allclose(to.float().numpy(), jo, rtol=0,
                               atol=3 * 2 ** -8 * np.abs(jo).max())
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


def test_numpy_inputs_are_placed_on_the_device():
    args = _inputs(T=16, E=4, seed=7)
    out, aux = tm.moe_ffn(*args, top_k=2, device="cpu")
    assert out.device.type == "cpu" and out.shape == (16, 32)
    ref, _ = tm.moe_ffn(*map(torch.from_numpy, args), top_k=2)
    assert torch.equal(out, ref)
