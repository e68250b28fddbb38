"""The adc_score_blocks and lstm_sequence kernels (csrc/adc.cu, csrc/lstm.cu)
against their plain versions on the card, at the edges of their tilings.

Marked `cuda`: the `card` fixture skips them where no GPU is present (it
decides inside the fixture, never at import). On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_adc_lstm.py

Tolerances: adc_score_blocks bitwise (both add lut[b, j, code] over
ascending j into one fp32 accumulator, no FMA); lstm_sequence atol 1e-5
(the kernel adds (x . wx + b) + h . wh in another order than the plain
version's (x @ wx + h @ wh) + b).
"""

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.adc import adc_score_blocks, adc_score_blocks_ref
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


def _adc_inputs(card, B, nsub, U, cap, S, K=256):
    g = _gen()
    lut = torch.randn(B, nsub, K, device=card, generator=g)
    codes = torch.randint(0, K, (U, cap, nsub), device=card, generator=g,
                          dtype=torch.uint8)
    sel = torch.randint(0, U, (B, S), device=card, generator=g,
                        dtype=torch.int32)
    return lut, codes, sel


def _adc_bitwise(lut, codes, sel):
    before = kernels.LAUNCHES["adc_score_blocks"]
    out = adc_score_blocks(lut, codes, sel)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["adc_score_blocks"] == before + 1
    ref = adc_score_blocks_ref(lut, codes, sel)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("nsub", [96, 48, 12, 8])
@pytest.mark.parametrize("cap", [256, 128, 100])
def test_adc_score_blocks_nsub_and_cap(card, nsub, cap):
    """uint4 rows (nsub 96, 48) and byte rows (12, 8); cap 256 (two slots
    a block), 128 and 100 (four, the last warp of a row part-full)."""
    _adc_bitwise(*_adc_inputs(card, 6, nsub, 40, cap, 32))


@pytest.mark.parametrize("S", [1, 32, 33])
def test_adc_score_blocks_slot_counts(card, S):
    """One slot (a block of one row group), 32 (16 rounds of two), 33 (a
    last round with one slot)."""
    _adc_bitwise(*_adc_inputs(card, 5, 96, 64, 256, S))


@pytest.mark.parametrize("U,B", [(512, 16), (3, 9)])
def test_adc_score_blocks_whole_table_and_few_blocks(card, U, B):
    """U a whole N-block code table indexed by cluster id (the PQStore
    path), and a few unique blocks shared by every slot (the v2 path)."""
    _adc_bitwise(*_adc_inputs(card, B, 96, U, 256, 32))


@pytest.mark.parametrize("offset,nsub", [(1, 96), (4, 96), (8, 48), (3, 12),
                                         (2, 8)])
def test_adc_score_blocks_codes_at_a_misaligned_base(card, offset, nsub):
    """A contiguous codes view whose base is 1, 2, 3, 4 or 8 bytes past an
    allocation: byte loads, never a misaligned vector load."""
    lut, codes, sel = _adc_inputs(card, 4, nsub, 17, 128, 8)
    buf = torch.empty(codes.numel() + offset, dtype=torch.uint8, device=card)
    view = buf[offset:].view(codes.shape)
    view.copy_(codes)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset % 16
    _adc_bitwise(lut, view, sel)


def test_adc_score_blocks_other_k(card):
    """A LUT of K 17 entries per subspace (codes below 17): the byte path."""
    _adc_bitwise(*_adc_inputs(card, 3, 5, 6, 33, 4, K=17))


def test_adc_score_blocks_out_of_range_slot_is_nan(card):
    lut, codes, sel = _adc_inputs(card, 4, 96, 10, 256, 6)
    bad = sel.clone()
    bad[0, 1], bad[2, 5], bad[3, 0] = -1, 10, 1 << 20
    out = adc_score_blocks(lut, codes, bad)
    torch.cuda.synchronize()
    hit = torch.zeros_like(sel, dtype=torch.bool)
    hit[0, 1] = hit[2, 5] = hit[3, 0] = True
    assert torch.isnan(out[hit]).all()
    ref = adc_score_blocks_ref(lut, codes, sel)
    assert torch.equal(out[~hit], ref[~hit])


def _lstm_inputs(card, B, n, F, H):
    g = _gen()
    x = torch.randn(B, n, F, device=card, generator=g)
    wx = torch.randn(F, 4 * H, device=card, generator=g) / F ** 0.5
    wh = torch.randn(H, 4 * H, device=card, generator=g) / H ** 0.5
    b = 0.1 * torch.randn(4 * H, device=card, generator=g)
    return x, wx, wh, b


def _lstm_close(x, wx, wh, b):
    before = kernels.LAUNCHES["lstm_sequence"]
    out = lstm_sequence(x, wx, wh, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lstm_sequence"] == before + 1
    torch.testing.assert_close(out, lstm_sequence_ref(x, wx, wh, b),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("B", [1, 3, 256, 257])
def test_lstm_sequence_batch_edges(card, B):
    """One row (the recsys query), a part-full tile, 128 full tiles, and
    one row past them."""
    _lstm_close(*_lstm_inputs(card, B, 32, 21, 32))


@pytest.mark.parametrize("H", [16, 32, 64, 8])
@pytest.mark.parametrize("n,F", [(1, 21), (32, 13), (64, 21), (33, 7)])
def test_lstm_sequence_steps_features_and_hidden(card, n, F, H):
    """n 1, 32, 33 and 64 (two chunks of staged projections); F 21 and odd
    F; H 32 (a row per warp), 16 (two rows per warp), and 8 and 64 (the
    generic kernel)."""
    _lstm_close(*_lstm_inputs(card, 5, n, F, H))


def test_lstm_sequence_saturated_gates(card):
    """Biases of +-40 and +-100 saturate every gate (expf(-x) overflows to
    inf at -100), and c grows by one a step: the cell's activations give
    exact 0, 1 and +-1 as the plain version's do."""
    x, wx, wh, b = _lstm_inputs(card, 7, 32, 21, 32)
    g = _gen()
    levels = torch.tensor([-100.0, -40.0, 40.0, 100.0], device=card)
    b = levels[torch.randint(0, 4, b.shape, device=card, generator=g)]
    _lstm_close(x, wx, wh, b)
