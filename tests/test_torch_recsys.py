"""The port's recsys models against the JAX package, on the CPU, on the
same numpy inputs: the JAX params tree (drawn with jax.random) carried
across with repro_torch.convert.recsys_params_from_numpy, the same
RecsysStream batches.

Tolerances:
  * embedding_bag's plain version against the JAX reference and the
    Pallas kernel in interpret mode: 1e-5 (float32) and 3e-2 (bfloat16),
    atol 4x, as tests/test_kernels.py holds the Pallas kernel; float32
    bags are also bitwise the JAX Python sum of lookups.
  * the towers and the wide-branch bags: bitwise (float32 sums of the
    same rows in the same order), but dlrm's user tower, an MLP: rtol
    1e-5, atol 1e-6.
  * forward logits of all four kinds: rtol 1e-5, atol 1e-5: matmuls and
    reductions summed in another order.
  * make_retrieval_step: ids equal at every rank whose score is more than
    1e-5 from both neighbours' (the u.v dots are summed in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import isolated_ranks
from repro.configs import get_config as jax_get_config
from repro.data.recsys_stream import RecsysStream as JaxRecsysStream
from repro.kernels.embedding_bag import embedding_bag as jax_embedding_bag
from repro.kernels.embedding_bag import embedding_bag_ref as jax_bag_ref
from repro.models import recsys as jrs
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.convert import recsys_params_from_numpy
from repro_torch.data import RecsysStream
from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref
from repro_torch.models import recsys as rs

KINDS = ["wide-deep", "deepfm", "dlrm-mlperf", "din"]


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _state(arch, seed=0, B=24):
    """(torch cfg, jax cfg, jax params, torch model on the CPU, numpy
    batch without labels)."""
    jcfg = jax_get_config(arch, "smoke")
    tcfg = get_config(arch, "smoke")
    jp = jrs.init_params(jcfg, jax.random.key(seed))
    np_params = jax.tree.map(np.asarray, jp)
    model = rs.RecsysModel(tcfg, recsys_params_from_numpy(
        tcfg, np_params, device="cpu"), device="cpu")
    batch = {k: v for k, v in RecsysStream(tcfg, seed=seed + 1).batch(B)
             .items() if k != "label"}
    return tcfg, jcfg, jp, model, batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_ref_matches_jax_ref_and_pallas(dtype):
    tol = 1e-5 if dtype == "float32" else 3e-2
    for V, d, B, hot in [(100, 32, 8, 1), (500, 64, 12, 4), (64, 128, 3, 9)]:
        rng = np.random.default_rng(V + d)
        table = rng.standard_normal((V, d)).astype(np.float32)
        idx = rng.integers(0, V, (B, hot)).astype(np.int32)
        jt = jnp.asarray(table, getattr(jnp, dtype))
        tt = torch.from_numpy(table).to(getattr(torch, dtype))
        got = embedding_bag(tt, torch.from_numpy(idx)).float().numpy()
        for want in (jax_bag_ref(jt, jnp.asarray(idx)),
                     jax_embedding_bag(jt, jnp.asarray(idx))):
            np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                       rtol=tol, atol=4 * tol)
        if dtype == "float32":   # the JAX model's Python sum of lookups
            want = sum(jrs.embedding_lookup(jt, jnp.asarray(idx[:, h]))
                       for h in range(hot))
            assert np.array_equal(_bits(got), _bits(want))
    assert embedding_bag_ref(tt, torch.zeros((0, 3), dtype=torch.int32)) \
        .shape == (0, 128)


def test_embedding_bag_variants_match_jax_and_bad_indices_raise():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    idx = rng.integers(0, 50, (4, 3, 5)).astype(np.int32)
    w = rng.random((4, 3, 5)).astype(np.float32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    for kw in ({}, {"weights": w}, {"combine": "mean"}, {"combine": "max"}):
        want = jrs.embedding_bag(jt, jnp.asarray(idx), **{
            k: jnp.asarray(v) if k == "weights" else v
            for k, v in kw.items()})
        got = rs.embedding_bag(tt, torch.from_numpy(idx), **{
            k: torch.from_numpy(v) if k == "weights" else v
            for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=str(kw))
    flat = rng.integers(0, 50, 20).astype(np.int32)
    seg = np.sort(rng.integers(-1, 7, 20)).astype(np.int32)   # -1 dropped
    want = jrs.embedding_bag_ragged(jt, jnp.asarray(flat), jnp.asarray(seg),
                                    6, weights=jnp.asarray(w.ravel()[:20]))
    got = rs.embedding_bag_ragged(tt, torch.from_numpy(flat),
                                  torch.from_numpy(seg), 6,
                                  weights=torch.from_numpy(w.ravel()[:20]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    for bad in (-1, 50):
        with pytest.raises(IndexError, match="outside the table"):
            embedding_bag(tt, torch.tensor([[0, bad]], dtype=torch.int32))
    with pytest.raises(ValueError, match="aliens"):
        rs.embedding_bag(tt, torch.from_numpy(idx), combine="aliens")


def test_params_conversion_fuses_the_padded_tables():
    tcfg, jcfg, jp, model, _ = _state("wide-deep")
    rows = [rs._padded_rows(r) for r in tcfg.table_sizes]
    assert rows == [jp["tables"][f"t{i}"].shape[0]
                    for i in range(len(rows))]
    fused = model.params["tables"]
    assert fused.weight.shape == (sum(rows), tcfg.embed_dim)
    assert fused.offsets.dtype == torch.int32
    assert fused.offsets.tolist() == np.cumsum([0] + rows[:-1]).tolist()
    for group in ("tables", "wide"):
        for i in range(len(rows)):
            view = model.params[group][f"t{i}"]
            assert view.data_ptr() == (model.params[group].weight.data_ptr()
                                       + 4 * fused.offsets[i].item()
                                       * view.shape[1])
            assert np.array_equal(view.numpy(),
                                  np.asarray(jp[group][f"t{i}"]))
    assert model.params["wide"].weight.shape == (sum(rows), 1)
    bad = jax.tree.map(np.asarray, jp)
    bad["deep_w0"] = bad["deep_w0"][:, :3]
    with pytest.raises(ValueError, match="deep_w0"):
        recsys_params_from_numpy(tcfg, bad, device="cpu")
    # the port's own init: the template's shapes, zero biases
    own = rs.init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    assert own["tables"].weight.shape == fused.weight.shape
    assert not own["deep_b0"].any() and own["deep_w0"].std() > 0


@pytest.mark.parametrize("arch", KINDS)
def test_forward_and_serve_match_jax(arch):
    tcfg, jcfg, jp, model, batch = _state(arch)
    # the configs and the id stream are copies of the JAX package's
    for size in ("full", "smoke"):
        t, j = get_config(arch, size), jax_get_config(arch, size)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.total_rows() == j.total_rows()
    want = JaxRecsysStream(jcfg, seed=1).batch(24)
    got = RecsysStream(tcfg, seed=1).batch(24)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    want = np.asarray(jrs.forward(jcfg, jp, _jb(batch)))
    tb = rs.as_batch(batch, "cpu")
    got = model(tb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    served = rs.make_serve_step(tcfg)(model, tb).numpy()
    np.testing.assert_allclose(
        served, np.asarray(jrs.make_serve_step(jcfg)(jp, _jb(batch))),
        rtol=1e-5, atol=1e-5)
    assert got.shape == (24,) and np.isfinite(got).all()


@pytest.mark.parametrize("arch", KINDS)
def test_towers_and_wide_bags_match_jax(arch):
    tcfg, jcfg, jp, model, batch = _state(arch, seed=4)
    jb, tb = _jb(batch), rs.as_batch(batch, "cpu")
    u_j = jrs.user_tower(jcfg, jp, jb)
    u_t = model.user_tower(tb)
    if arch == "dlrm-mlperf":
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-5,
                                   atol=1e-6)
    else:
        assert np.array_equal(_bits(u_t), _bits(u_j))
    cand = batch["sparse"][:, :2]
    v_j = jrs.candidate_tower(jcfg, jp, jnp.asarray(cand))
    v_t = model.candidate_tower(torch.from_numpy(cand))
    assert np.array_equal(_bits(v_t), _bits(v_j))
    if "wide" in jp:
        sparse = batch["sparse"]
        want = sum(jrs.embedding_lookup(jp["wide"][f"t{i}"],
                                        jnp.asarray(sparse[:, i]))[:, 0]
                   for i in range(sparse.shape[1]))
        got = model.params["wide"].bag(torch.from_numpy(sparse))[:, 0]
        assert np.array_equal(_bits(got), _bits(want))


def test_make_retrieval_step_matches_jax():
    for arch in ("wide-deep", "dlrm-mlperf"):
        tcfg, jcfg, jp, model, batch = _state(arch, seed=7, B=3)
        rng = np.random.default_rng(8)
        cand = np.stack([rng.integers(0, tcfg.table_sizes[i], 3000)
                         for i in range(2)], 1).astype(np.int32)
        js, ji = jrs.make_retrieval_step(jcfg, k=50)(jp, _jb(batch),
                                                     jnp.asarray(cand))
        before = dict(kernels.LAUNCHES)
        ts, ti = rs.make_retrieval_step(tcfg, k=50)(
            model, rs.as_batch(batch, "cpu"), torch.from_numpy(cand))
        assert kernels.LAUNCHES == before     # the CPU path launches nothing
        assert ti.dtype == torch.int32 and ti.shape == (3, 50)
        ok = isolated_ranks(np.asarray(js))
        assert ok.sum() > 100, arch
        np.testing.assert_array_equal(ti.numpy()[ok], np.asarray(ji)[ok],
                                      err_msg=arch)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-6, err_msg=arch)
