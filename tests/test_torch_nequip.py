"""The port's NequIP (repro_torch.models.nequip) against the JAX
package's `repro.models.nequip` at `smoke()` widths (and `full()` on one
small batch), params from JAX's init carried across by
`convert.nequip_params_from_numpy`, batches from the numpy builders.

Tolerances (float32 on the CPU; einsums and segment sums add in another
order): the constants bitwise; to5/from5/symtr, each tensor-product path
and the radial basis rtol 1e-5, atol 1e-6; energies and the loss rtol
1e-5, atol 1e-6; gradients rtol 1e-4, atol 1e-7; one AdamW step as the
dense LM test's `_step_close` holds it. Energy invariance under a
rotation and a translation at JAX's own tolerance (rtol 2e-4, atol
2e-5, tests/test_equivariance.py). Measured here: the CPU forward is
not bitwise JAX's (the einsums' sums run in another order); the
largest energy difference on the smoke molecules is a few float32 ulps.
"""

import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:                      # fall back to deterministic sweeps
    from _hypothesis_stub import given, settings
    from _hypothesis_stub import strategies as st

from repro.configs import get_config as jget
from repro.data.graphs import synth_molecules
from repro.models import nequip as jn
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import get_config as tget
from repro_torch.convert import nequip_params_from_numpy
from repro_torch.models import nequip as tn

from test_torch_transformer import _step_close

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               **(tol or TOL))


def _setup(variant="smoke", d_feat=0, seed=0):
    jc, tc = jget("nequip", variant), tget("nequip", variant)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jp = jn.init_params(jc, jax.random.key(seed), d_feat)
    tp = nequip_params_from_numpy(tc, jax.tree.map(np.asarray, jp), d_feat,
                                  device="cpu")
    return jc, tc, jp, tp


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


def test_constants_match_jax():
    assert np.asarray(jn.L2_BASIS).tobytes() == tn.L2_BASIS.numpy().tobytes()
    assert tn.L2_BASIS.dtype == torch.float32
    assert np.asarray(jn.EPS3).tobytes() == tn.EPS3.numpy().tobytes()
    assert tn.PATHS == jn.PATHS and tn.N_PATHS == jn.N_PATHS == 15
    assert tn.RADIAL_HIDDEN == jn.RADIAL_HIDDEN == 64


def test_to5_from5_symtr_match_jax():
    A = np.random.default_rng(0).standard_normal((7, 4, 3, 3)) \
        .astype(np.float32)
    jA, tA = jnp.asarray(A), torch.from_numpy(A)
    _close(tn.symtr(tA), jn.symtr(jA))
    M = tn.symtr(tA)
    _close(tn.to5(M), jn.to5(jnp.asarray(M.numpy())))
    f = np.random.default_rng(1).standard_normal((7, 4, 5)).astype(np.float32)
    _close(tn.from5(torch.from_numpy(f)), jn.from5(jnp.asarray(f)))
    torch.testing.assert_close(tn.from5(tn.to5(M)), M, rtol=0, atol=1e-5)


def test_each_tensor_product_path_matches_jax():
    """Each of the 15 paths alone (its radial weight on, the others 0),
    then all at once."""
    rng = np.random.default_rng(4)
    E, C = 16, 4
    h0 = rng.standard_normal((E, C)).astype(np.float32)
    h1 = rng.standard_normal((E, C, 3)).astype(np.float32)
    h2 = np.asarray(jn.symtr(jnp.asarray(
        rng.standard_normal((E, C, 3, 3)), jnp.float32)))
    y0 = np.ones(E, np.float32)
    y1 = rng.standard_normal((E, 3)).astype(np.float32)
    y1 /= np.linalg.norm(y1, axis=-1, keepdims=True)
    y2 = np.asarray(jn.symtr(jnp.einsum("ei,ej->eij", y1, y1)))
    w = rng.standard_normal((E, tn.N_PATHS, C)).astype(np.float32)
    for p in list(range(tn.N_PATHS)) + [None]:
        wp = w if p is None else w * (np.arange(tn.N_PATHS) == p)[
            None, :, None].astype(np.float32)
        args = (h0, h1, h2, y0, y1, y2, wp)
        J = jn.tensor_product(*map(jnp.asarray, args))
        T = tn.tensor_product(*(torch.from_numpy(np.array(a))
                                for a in args))
        for l3, (a, b) in enumerate(zip(T, J)):
            if p is not None and tn.PATHS[p][2] != l3:
                assert not np.asarray(b).any() and not a.any()
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=2e-6,
                                           err_msg=f"path {p} l3 {l3}")


def test_bessel_rbf_matches_jax():
    r = np.concatenate([[0.0, 1e-7, 1e-6], np.linspace(0.01, 6, 200)]) \
        .astype(np.float32)
    for n_rbf, cutoff in ((8, 5.0), (4, 3.0)):
        _close(tn.bessel_rbf(torch.from_numpy(r), n_rbf, cutoff),
               jn.bessel_rbf(jnp.asarray(r), n_rbf, cutoff))


@pytest.mark.parametrize("variant", ["smoke", "full"])
def test_forward_on_molecules_matches_jax(variant):
    jc, tc, jp, tp = _setup(variant)
    b = synth_molecules(3, 6, 12, 32, n_species=tc.n_species)
    jb, tb = _both(b)
    with torch.no_grad():
        te = tn.forward(tc, tp, tb)
    je = jn.forward(jc, jp, jb)
    assert te.shape == (6,) and torch.isfinite(te).all()
    _close(te, je)


def _padded(d_feat=6, n=400, e=3000, seed=0):
    from repro_torch.data import sampler as ts

    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    feats = rng.standard_normal((n, d_feat)).astype(np.float32)
    g = ts.CSRGraph.from_edges(src, dst, n)
    b = ts.padded_batch(g, feats, np.arange(16), (5, 3),
                        np.random.default_rng(1), max_nodes=320,
                        max_edges=400,
                        targets=rng.standard_normal(n).astype(np.float32))
    b["positions"] = (3.0 * np.random.default_rng(2).standard_normal(
        (320, 3))).astype(np.float32)
    return b


def test_forward_and_loss_on_a_padded_batch_match_jax():
    """node_feat in place of species, node_mask, energy_weight (the
    ignore bucket weighted 0), padded edges (mask 0, src = dst = 0)."""
    jc, tc, jp, tp = _setup(d_feat=6)
    b = _padded()
    assert b["edge_mask"].min() == 0 and b["node_mask"].min() == 0
    jb, tb = _both(b)
    with torch.no_grad():
        _close(tn.forward(tc, tp, tb), jn.forward(jc, jp, jb))
        tl = tn.loss_fn(tc, tp, tb)
    jl = jax.jit(lambda p, b: jax.value_and_grad(
        lambda q: _jax_loss(jc, q, b))(p))(jp, jb)[0]
    _close(tl, jl)


def _jax_loss(jc, p, b):
    e = jn.forward(jc, p, b)
    err = jnp.square(e - b["energy_target"])
    if "energy_weight" in b:
        w = b["energy_weight"]
        return jnp.sum(err * w) / jnp.maximum(jnp.sum(w), 1.0)
    return jnp.mean(err)


def test_out_of_range_ids_are_dropped_as_jax_drops_them():
    """A species >= n_species embeds as a zero row (jax.nn.one_hot), a
    graph id outside [0, n_graphs) is dropped (jax.ops.segment_sum); and
    padded edges send exact zeros: appending them leaves the port's
    energies bitwise unchanged."""
    jc, tc, jp, tp = _setup()
    b = synth_molecules(5, 4, 10, 32, n_species=tc.n_species)
    b["species"][::7] = tc.n_species + 3
    b["graph_id"][::5] = 4                  # == n_graphs
    b["graph_id"][1::9] = -1
    jb, tb = _both(b)
    with torch.no_grad():
        te = tn.forward(tc, tp, tb)
    _close(te, jn.forward(jc, jp, jb))
    pad = dict(b)
    for k, fill in (("edge_src", 0), ("edge_dst", 0), ("edge_mask", 0)):
        pad[k] = np.concatenate([b[k], np.full(40, fill, b[k].dtype)])
    with torch.no_grad():
        tp_e = tn.forward(tc, tp, _both(pad)[1])
    assert tp_e.numpy().tobytes() == te.numpy().tobytes()
    seg = tn.segment_sum(torch.ones(5, 2), torch.tensor([0, 3, 2, -1, 2]), 3)
    assert seg.tolist() == [[1.0, 1.0], [0.0, 0.0], [2.0, 2.0]]


def _random_batch(seed, N=40, E=150, G=2):
    rng = np.random.default_rng(seed)
    return {
        "positions": (rng.standard_normal((N, 3)) * 2).astype(np.float32),
        "species": rng.integers(0, 8, N).astype(np.int32),
        "edge_src": rng.integers(0, N, E).astype(np.int32),
        "edge_dst": rng.integers(0, N, E).astype(np.int32),
        "edge_mask": np.ones(E, np.float32),
        "graph_id": rng.integers(0, G, N).astype(np.int32),
        "energy_target": np.zeros(G, np.float32),
    }


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 10_000))
def test_energy_rotation_translation_invariant(seed):
    from scipy.spatial.transform import Rotation

    tc = tget("nequip", "smoke")
    tp = tn.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _random_batch(seed % 3).items()}
    R = torch.from_numpy(Rotation.random(random_state=seed).as_matrix()
                         .astype(np.float32))
    t = torch.from_numpy(np.random.default_rng(seed).standard_normal(3)
                         .astype(np.float32))
    with torch.no_grad():
        e0 = tn.forward(tc, tp, b)
        e1 = tn.forward(tc, tp, dict(b, positions=b["positions"] @ R.T + t))
    np.testing.assert_allclose(e0.numpy(), e1.numpy(), rtol=2e-4, atol=2e-5)


def test_one_train_step_matches_jax():
    from repro.optim import adamw_init as jinit
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw_init

    jc, tc, jp, tp = _setup()
    b = synth_molecules(1234, 8, 12, 32, n_species=tc.n_species)
    jb, tb = _both(b)
    jl, jg = jax.value_and_grad(lambda p: _jax_loss(jc, p, jb))(jp)
    tl, tg = tn.value_and_grad(tc, tp, tb)
    _close(tl, jl)
    for a, c in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        _close(a, c, rtol=1e-4, atol=1e-7)
    from repro.models.nequip import make_train_step as jstep
    jP, jO, jm = jax.jit(jstep(jc))(jp, jinit(jp), jb)
    tP, tO, tm = tn.make_train_step(tc)(tp, adamw_init(tp), tb)
    _close(tm["loss"], jm["loss"])
    _close(tm["grad_norm"], jm["grad_norm"], rtol=1e-4)
    lr = TrainConfig().lr
    _step_close(tP, tO, dict(tm, lr=torch.tensor(lr)), jP, jO,
                dict(jm, lr=np.float32(lr)), jp)


def test_init_params_follow_jax_template():
    for variant in ("smoke", "full"):
        for d_feat in (0, 602):
            jc, tc = jget("nequip", variant), tget("nequip", variant)
            want = jax.tree.map(lambda s: tuple(s.shape),
                                jn.abstract_params(jc, d_feat))
            p = tn.init_params(tc, torch.Generator().manual_seed(0), d_feat,
                               device="cpu")
            got = {k: ({n: tuple(x.shape) for n, x in v.items()}
                       if isinstance(v, dict) else tuple(v.shape))
                   for k, v in p.items()}
            assert got == want
    assert not p["layers"]["gate_b"].any()
    std = float(p["layers"]["radial_w2"].std())
    assert abs(std * tn.RADIAL_HIDDEN ** 0.5 - 1.0) < 0.05


def test_train_cli_on_nequip_smoke_recovers_from_a_failure(tmp_path):
    from repro_torch.launch import train as ttrain

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ttrain.main(["--arch", "nequip", "--variant", "smoke",
                          "--steps", "6", "--ckpt-every", "3", "--fail-at",
                          "4", "--ckpt-dir", str(tmp_path / "ck"),
                          "--device", "cpu"])
    assert rc == 0
    done = re.search(r"done: steps=(\d+) restarts=(\d+) loss (\S+) -> (\S+)",
                     out.getvalue())
    assert done and done.group(1, 2) == ("7", "1")
    assert np.isfinite(float(done.group(3))) and np.isfinite(
        float(done.group(4)))
