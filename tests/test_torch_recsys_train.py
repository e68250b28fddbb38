"""The port's recsys `make_train_step` against the JAX module's, on the
CPU, for all four recsys configs at `smoke()` widths: the JAX params
tree (drawn with jax.random) carried across, the same RecsysStream
batch, one step and then three.

The port keeps each config's tables as one fused (rows, d) weight
(`FusedTable`); its gradients and updated params are cut back into JAX's
per-field `t{i}` leaves by their row offsets.

Tolerances: the loss and the gradients rtol 1e-5, atol 1e-6 (matmuls
and reductions summed in another order; duplicate rows' gradients
added in another order); the params after Adam steps rtol 1e-5, atol
1e-6 as well; the grad norm rtol 1e-5 (one fused sum of squares
against JAX's per-table sums). One leaf is held apart: din's
`attn_out_b` shifts every attention logit of a row alike, and the
softmax does not see a shift, so its gradient is a sum that cancels to
0 in exact arithmetic; both packages leave about 1e-6 of rounding
there (atol 1e-5), and Adam turns that noise into a step of about lr
either way (after 3 steps within 6 * lr of each other).
"""

import _torch_parity  # noqa: F401  (first: it caps torch at 2 threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import recsys as jrs
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import TrainConfig, get_config
from repro_torch.convert import recsys_params_from_numpy
from repro_torch.data import RecsysStream
from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref
from repro_torch.models import recsys as rs
from repro_torch.optim import adamw_init

KINDS = ["wide-deep", "deepfm", "dlrm-mlperf", "din"]
TOL = dict(rtol=1e-5, atol=1e-6)


def _split(tcfg, tree):
    """train_tree-layout leaves -> the JAX tree's names, tables cut into
    their per-field t{i} rows, as numpy."""
    out = {}
    tmpl = rs.param_template(tcfg)
    for k, v in tree.items():
        v = v.detach().numpy() if isinstance(v, torch.Tensor) else v
        if isinstance(tmpl[k], dict):
            rows = np.cumsum([0] + [tmpl[k][f"t{i}"].shape[0]
                                    for i in range(len(tmpl[k]))])
            out[k] = {f"t{i}": v[rows[i]:rows[i + 1]]
                      for i in range(len(rows) - 1)}
        else:
            out[k] = v
    return out


def _state(arch, seed=0, B=32):
    jcfg = jax_get_config(arch, "smoke")
    tcfg = get_config(arch, "smoke")
    jp = jrs.init_params(jcfg, jax.random.key(seed))
    params = recsys_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                      device="cpu")
    batch = RecsysStream(tcfg, seed=seed + 1).batch(B)
    return tcfg, jcfg, jp, params, batch


# leaves whose exact value is 0 (see the module docstring): grad atol,
# and the params' atol after n Adam steps per step
CANCELLING = {"din": {"attn_out_b": (1e-5, 2 * TrainConfig().lr)}}


def _assert_tree_close(got, want, loose=None, **tol):
    want = jax.tree.map(np.asarray, want)
    for k in want:
        if loose and k in loose:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=loose[k], err_msg=k)
        elif isinstance(want[k], dict):
            for t in want[k]:
                np.testing.assert_allclose(got[k][t], want[k][t], **tol,
                                           err_msg=f"{k}/{t}")
        else:
            np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)


@pytest.mark.parametrize("arch", KINDS)
def test_make_train_step_matches_jax(arch):
    tcfg, jcfg, jp, params, batch = _state(arch)
    cancel = CANCELLING.get(tcfg.kind, {})
    tb = rs.as_batch(batch, "cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    # one step's loss and gradients against JAX's value_and_grad
    def jloss(p):
        logit = jrs.forward(jcfg, p, jb)
        y = jb["label"].astype(jnp.float32)
        return jnp.mean(jnp.maximum(logit, 0) - logit * y
                        + jnp.log1p(jnp.exp(-jnp.abs(logit))))

    jl, jg = jax.value_and_grad(jloss)(jp)
    loss, grads = rs.train_loss_and_grads(tcfg, params, tb)
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    _assert_tree_close(_split(tcfg, grads), jg,
                       {k: v[0] for k, v in cancel.items()}, **TOL)
    # the padded rows of every table get no gradient
    for k, v in _split(tcfg, grads).items():
        if isinstance(v, dict):
            assert all(np.isfinite(x).all() for x in v.values())

    # three steps of each package's make_train_step
    tc = TrainConfig()
    jstep = jax.jit(jrs.make_train_step(jcfg))
    tstep = rs.make_train_step(tcfg, tc)
    jopt = jax_adamw_init(jp)
    topt = adamw_init(rs.train_tree(params))
    for i in range(3):
        jp, jopt, jst = jstep(jp, jopt, jb)
        params, topt, tst = tstep(params, topt, tb)
        np.testing.assert_allclose(float(tst["loss"]), float(jst["loss"]),
                                   **TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(tst["grad_norm"]),
                                   float(jst["grad_norm"]), rtol=1e-5)
    assert int(topt["count"]) == int(jopt["count"]) == 3
    _assert_tree_close(_split(tcfg, rs.train_tree(params)), jp,
                       {k: 3 * v[1] for k, v in cancel.items()}, **TOL)
    _assert_tree_close(_split(tcfg, topt["mu"]), jopt["mu"],
                       {k: v[0] for k, v in cancel.items()}, **TOL)
    assert isinstance(params["tables"], rs.FusedTable)


def test_embedding_bag_backward_is_the_plain_vjp():
    """The op's autograd Function (forward the bag, backward an
    index_add_ into the rows) against autograd through the plain version
    and against JAX's gradient of its jnp.take sum, with repeated rows
    in one bag and across bags."""
    rng = np.random.default_rng(4)
    V, d, B, hot = 50, 8, 12, 5
    table = rng.standard_normal((V, d)).astype(np.float32)
    idx = rng.integers(0, 10, (B, hot)).astype(np.int32)
    g = rng.standard_normal((B, d)).astype(np.float32)

    t1 = torch.from_numpy(table).requires_grad_()
    out = embedding_bag(t1, torch.from_numpy(idx))
    (gt,) = torch.autograd.grad(out, t1, torch.from_numpy(g))
    t2 = torch.from_numpy(table).requires_grad_()
    ref = embedding_bag_ref(t2, torch.from_numpy(idx))
    (gr,) = torch.autograd.grad(ref, t2, torch.from_numpy(g))
    assert torch.equal(out.detach(), ref.detach())
    np.testing.assert_allclose(gt.numpy(), gr.numpy(), rtol=1e-6, atol=1e-6)
    assert np.all(gt.numpy()[10:] == 0)

    def jbag(t):
        return sum(jnp.take(t, jnp.asarray(idx[:, h]), axis=0)
                   for h in range(hot))
    _, vjp = jax.vjp(jbag, jnp.asarray(table))
    (jg,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(gt.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    # no grad wanted: the plain op, no Function node
    with torch.no_grad():
        assert embedding_bag(t1, torch.from_numpy(idx)).grad_fn is None


def test_train_tree_round_trip_keeps_fields_and_offsets():
    tcfg, _, _, params, _ = _state("wide-deep")
    tree = rs.train_tree(params)
    assert sorted(tree) == sorted(params)
    assert tree["tables"].shape == params["tables"].weight.shape
    back = rs._from_tree(params, {k: v.clone() for k, v in tree.items()})
    assert back["tables"].rows == params["tables"].rows
    assert back["tables"].offsets is params["tables"].offsets
    assert torch.equal(back["tables"]["t3"], params["tables"]["t3"])
    assert not back["tables"].weight.requires_grad
