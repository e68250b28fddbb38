"""The port's kernel packages on the CPU: each plain version (ref.py) is
held to the JAX package's Pallas kernel, run in interpret mode, on the
same numpy inputs.

Tolerances:
  * adc_score_blocks: bitwise. Both sum lut[b, j, code] over ascending j
    into one float32 accumulator.
  * adc_tables: rtol 1e-6, atol 1e-6: the same dsub-long dots, summed
    in another order (and with FMAs) by XLA's dot; on O(1) inputs a
    float32 dot of dsub <= 8 terms is off by at most a few ulps of the
    larger terms, which is what atol covers for entries near 0.
  * lstm_sequence: atol 1e-5: matmuls and transcendentals of two
    libraries over 12 steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_tensor as _t
from repro.kernels.adc import adc_score_blocks as jax_adc_score_blocks
from repro.kernels.adc import adc_tables as jax_adc_tables
from repro.kernels.lstm.kernel import lstm_sequence_pallas
from repro_torch import kernels
from repro_torch.kernels.adc import (adc_score_blocks, adc_score_blocks_ref,
                                     adc_tables, adc_tables_ref)
from repro_torch.kernels.lstm import lstm_sequence, lstm_sequence_ref



@pytest.mark.parametrize("B,nsub,dsub,K", [(3, 8, 4, 256), (2, 5, 3, 17),
                                           (1, 96, 8, 256)])
def test_adc_tables_ref_matches_jax_kernel(B, nsub, dsub, K):
    rng = np.random.default_rng(B * 100 + nsub)
    q = rng.standard_normal((B, nsub * dsub)).astype(np.float32)
    books = rng.standard_normal((nsub, K, dsub)).astype(np.float32)
    want = np.asarray(jax_adc_tables(jnp.asarray(q), jnp.asarray(books),
                                     use_kernel=True))
    got = adc_tables_ref(_t(q), _t(books)).numpy()
    assert got.shape == (B, nsub, K) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_adc_tables_folds_rotation_like_jax():
    rng = np.random.default_rng(5)
    B, nsub, dsub = 4, 8, 4
    dim = nsub * dsub
    q = rng.standard_normal((B, dim)).astype(np.float32)
    books = rng.standard_normal((nsub, 256, dsub)).astype(np.float32)
    rot, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    rot = rot.astype(np.float32)
    want = np.asarray(jax_adc_tables(jnp.asarray(q), jnp.asarray(books),
                                     jnp.asarray(rot), use_kernel=True))
    got = adc_tables(_t(q), _t(books), _t(rot)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,nsub,U,cap,S", [(3, 8, 6, 16, 4),
                                            (2, 5, 3, 7, 5),
                                            (2, 96, 8, 256, 3)])
def test_adc_score_blocks_ref_bitwise_vs_jax_kernel(B, nsub, U, cap, S):
    rng = np.random.default_rng(U * 10 + cap)
    lut = rng.standard_normal((B, nsub, 256)).astype(np.float32)
    codes = rng.integers(0, 256, (U, cap, nsub)).astype(np.uint8)
    sel = rng.integers(0, U, (B, S)).astype(np.int32)
    want = np.asarray(jax_adc_score_blocks(
        jnp.asarray(lut), jnp.asarray(codes), jnp.asarray(sel),
        use_kernel=True))
    got = adc_score_blocks_ref(_t(lut), _t(codes), _t(sel)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_adc_score_blocks_empty_selection_and_fetch():
    lut = torch.zeros((2, 4, 256))
    out = adc_score_blocks(lut, torch.zeros((3, 5, 4), dtype=torch.uint8),
                           torch.zeros((2, 0), dtype=torch.int32))
    assert out.shape == (2, 0, 5)
    out = adc_score_blocks(lut, torch.zeros((0, 5, 4), dtype=torch.uint8),
                           torch.zeros((2, 3), dtype=torch.int32))
    assert out.shape == (2, 3, 5) and not out.any()


@pytest.mark.parametrize("B,n,F,H", [(5, 12, 21, 32), (3, 7, 13, 16)])
def test_lstm_sequence_ref_matches_jax_kernel(B, n, F, H):
    rng = np.random.default_rng(B + n)
    x = rng.standard_normal((B, n, F)).astype(np.float32)
    wx = (rng.standard_normal((F, 4 * H)) / np.sqrt(F)).astype(np.float32)
    wh = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    b = (0.1 * rng.standard_normal(4 * H)).astype(np.float32)
    want = np.asarray(lstm_sequence_pallas(
        jnp.asarray(x), jnp.asarray(wx), jnp.asarray(wh), jnp.asarray(b),
        interpret=True))
    got = lstm_sequence_ref(_t(x), _t(wx), _t(wh), _t(b)).numpy()
    assert got.shape == (B, n, H)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_cpu_tensors_take_ref_without_counting_launches():
    kernels.reset_launches()
    rng = np.random.default_rng(0)
    lut = _t(rng.standard_normal((2, 4, 256)).astype(np.float32))
    codes = _t(rng.integers(0, 256, (3, 8, 4)).astype(np.uint8))
    sel = _t(rng.integers(0, 3, (2, 2)).astype(np.int32))
    torch.testing.assert_close(adc_score_blocks(lut, codes, sel),
                               adc_score_blocks_ref(lut, codes, sel),
                               rtol=0, atol=0)
    x = torch.randn(2, 3, 5)
    lstm_sequence(x, torch.randn(5, 8), torch.randn(2, 8), torch.zeros(8))
    adc_tables(torch.randn(2, 16), torch.randn(4, 256, 4))
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_wrappers_reject_tensors_on_mixed_devices():
    with pytest.raises(ValueError, match="devices"):
        kernels.on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))


def test_build_keys_libraries_by_source_hash():
    from repro_torch.kernels import build
    src_a, so_a = build._target("adc")
    src_l, so_l = build._target("lstm")
    assert src_a.exists() and src_l.exists()
    assert so_a.parent == build.BUILD_DIR and so_a != so_l
    assert so_a == build._target("adc")[1]          # stable across calls
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
