"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: the `card` fixture skips them where no GPU is present (it
decides inside the fixture, never at import). On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: adc_score_blocks bitwise (one fp32 accumulator, ascending
subspaces, no FMA); adc_tables rtol/atol 1e-5; lstm_sequence atol 1e-5.
"""

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.adc import (adc_score_blocks, adc_score_blocks_ref,
                                     adc_tables, adc_tables_ref)
from repro_torch.kernels.lstm import lstm_sequence, lstm_sequence_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen():
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("B,nsub,dsub,K", [(3, 8, 4, 256), (2, 5, 3, 17),
                                           (64, 96, 8, 256)])
def test_adc_tables_kernel_vs_plain(card, B, nsub, dsub, K):
    g = _gen()
    q = torch.randn(B, nsub * dsub, device=card, generator=g)
    books = torch.randn(nsub, K, dsub, device=card, generator=g)
    before = kernels.LAUNCHES["adc_tables"]
    out = adc_tables(q, books)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["adc_tables"] == before + 1
    torch.testing.assert_close(out, adc_tables_ref(q, books), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("B,nsub,U,cap,S", [(3, 8, 6, 16, 4),
                                            (2, 5, 3, 7, 5),
                                            (16, 96, 64, 256, 32)])
def test_adc_score_blocks_kernel_bitwise(card, B, nsub, U, cap, S):
    g = _gen()
    lut = torch.randn(B, nsub, 256, device=card, generator=g)
    codes = torch.randint(0, 256, (U, cap, nsub), device=card, generator=g,
                          dtype=torch.uint8)
    sel = torch.randint(0, U, (B, S), device=card, generator=g,
                        dtype=torch.int32)
    out = adc_score_blocks(lut, codes, sel)
    torch.cuda.synchronize()
    assert torch.equal(out, adc_score_blocks_ref(lut, codes, sel))


def test_adc_score_blocks_rejects_bad_inputs(card):
    lut = torch.randn(2, 4, 256, device=card)
    codes = torch.zeros(3, 8, 4, dtype=torch.uint8, device=card)
    with pytest.raises(TypeError):
        adc_score_blocks(lut, codes, torch.zeros(2, 2, dtype=torch.int64,
                                                 device=card))
    with pytest.raises(ValueError):
        adc_score_blocks(lut, codes, torch.zeros(2, 2, dtype=torch.int32))


@pytest.mark.parametrize("B,n,F,H", [(256, 32, 21, 32), (5, 7, 13, 16)])
def test_lstm_sequence_kernel_vs_plain(card, B, n, F, H):
    g = _gen()
    x = torch.randn(B, n, F, device=card, generator=g)
    wx = torch.randn(F, 4 * H, device=card, generator=g) / F ** 0.5
    wh = torch.randn(H, 4 * H, device=card, generator=g) / H ** 0.5
    b = 0.1 * torch.randn(4 * H, device=card, generator=g)
    out = lstm_sequence(x, wx, wh, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, lstm_sequence_ref(x, wx, wh, b),
                               rtol=0, atol=1e-5)
