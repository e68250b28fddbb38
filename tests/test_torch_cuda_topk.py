"""The chunked topk kernel (csrc/topk.cu) against its plain version, on
the card: values (as int32 bits) and int64 indices equal, on every shape.

Marked `cuda`: the `card` fixture skips them where no GPU is present (it
decides inside the fixture, never at import). On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_topk.py

The public op picks the chunking itself (`kernel.plan`); the tests of
chunk boundaries and of lists shorter than k also call the kernel with
explicit (C, L, kstride) chunkings, so that a chunk edge falls where the
test puts it.
"""

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.topk import kernel, topk, topk_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _gen():
    return torch.Generator(device="cuda").manual_seed(0)


def _same(got, x, k):
    rv, ri = topk_ref(x, k)
    v, i = got
    torch.cuda.synchronize()
    assert torch.equal(i, ri)
    assert torch.equal(v.view(torch.int32), rv.view(torch.int32))


def _chunked(x, k, C, L):
    """The kernel under an explicit chunking of its rows."""
    B = x.shape[0]
    kstride = 0 if C == 1 else (min(k, L) + 3) // 4 * 4
    vals = torch.empty((B, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, k), dtype=torch.long, device=x.device)
    scratch = torch.empty(2 * B * C * kstride, dtype=torch.int32,
                          device=x.device)
    kernel.topk_cuda(x, k, vals, idx, scratch, (C, L, kstride))
    return vals, idx


def _tied(B, D, g, levels=7):
    """Rows of few distinct values: heavy exact ties, signed zeros."""
    vals = torch.tensor([0.0, -0.0, 1.0, -1.0, 0.5, 2.0, -torch.inf],
                        device="cuda")[:levels]
    return vals[torch.randint(0, levels, (B, D), device="cuda",
                              generator=g)]


@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("k", [100, 2048])
def test_topk_at_chunk_boundaries(card, delta, k):
    """D = C*L - 1, C*L, C*L + 1 for chunks of L = 4096 (the last chunk
    then holds 4095, 4096 or 1 entries), and around the public op's own
    chunk length for one 1M-long row."""
    g = _gen()
    L = 4096
    D = 5 * L + delta
    x = torch.rand(3, D, device=card, generator=g)
    x[:, ::3] = 0.25                                # exact ties
    C = -(-D // L)
    _same(_chunked(x, k, C, L), x, k)
    C1, L1, _ = kernel.plan(1, 1 << 20, k, 132)
    D1 = C1 * L1 + delta
    y = torch.rand(1, D1, device=card, generator=g)
    _same(topk(y, k), y, k)


@pytest.mark.parametrize("extra", [1, 3])
def test_topk_reads_odd_row_strides(card, extra):
    """(B, D) views of (B, D + extra) buffers: rows start off a 16-byte
    boundary, so each chunk has an unaligned head and tail."""
    g = _gen()
    D = 300_001
    buf = torch.rand(4, D + extra, device=card, generator=g)
    buf[:, -extra:] = 9.0                           # never in a view's top-k
    x = buf[:, :D]
    assert x.stride(0) == D + extra
    for k in (1000, 7):
        _same(topk(x, k), x, k)
    _same(_chunked(x, 1000, 7, 42_860), x, 1000)


@pytest.mark.parametrize("fill", [0.0, 0.25, -0.0])
def test_topk_rows_of_one_value(card, fill):
    x = torch.full((2, 1 << 20), fill, device=card)
    for k in (1000, 2048):
        _same(topk(x, k), x, k)
    y = torch.full((3, 20_000), fill, device=card)
    _same(topk(y, 2048), y, 2048)


def test_topk_fewer_than_k_nonzeros(card):
    """The sparse rows: mostly exact zeros, fewer than k of them not; the
    lowest-indexed zeros fill the rest, across chunks."""
    g = _gen()
    x = torch.zeros(8, 1 << 20, device=card)
    at = torch.randint(0, 1 << 20, (8, 300), device=card, generator=g)
    x.scatter_(1, at, torch.rand(8, 300, device=card, generator=g) - 0.3)
    x[1] = 0.0
    for k in (1000, 2048):
        _same(topk(x, k), x, k)


def test_topk_neg_inf_and_signed_zeros(card):
    """The recsys guide's -inf pads, rows of -inf, and -0.0 ranked below
    +0.0."""
    g = _gen()
    D = 1 << 20
    x = torch.rand(2, D, device=card, generator=g)
    x[0, torch.rand(D, device=card, generator=g) < 0.9] = -torch.inf
    x[1] = -torch.inf
    x[1, :500] = 1.0
    _same(topk(x, 1024), x, 1024)
    z = _tied(4, 200_000, g, levels=2)              # only +0.0 and -0.0
    _same(topk(z, 1500), z, 1500)
    t = _tied(16, 20_000, g)
    _same(topk(t, 2048), t, 2048)


@pytest.mark.parametrize("k", [1, 100, 1024, 2048])
def test_topk_one_row_of_a_million(card, k):
    """B 1 with D 2^20, as the recsys guide, fuse and brute force give it;
    the op splits the row into chunks and launches once."""
    g = _gen()
    x = torch.randn(1, 1 << 20, device=card, generator=g)
    before = kernels.LAUNCHES["topk"]
    got = topk(x, k)
    assert kernels.LAUNCHES["topk"] == before + 1
    C, _, _ = kernel.plan(1, 1 << 20, k, 132)
    assert C > 1
    _same(got, x, k)


def test_topk_merge_reads_long_lists_in_place(card):
    """A row whose chunk lists hold more keys than the merge stages in
    shared memory (C * kstride > 49152): the merge reads them in place."""
    g = _gen()
    B, D, k = 2, 1_300_000, 2048
    C, _, kstride = kernel.plan(B, D, k, 132)
    assert C * kstride > 49152
    x = _tied(B, D, g, levels=6)
    x[0] = torch.randn(D, device="cuda", generator=g)
    _same(topk(x, k), x, k)


def test_topk_k_equal_to_d(card):
    g = _gen()
    for D in (1, 33, 2048):
        x = _tied(5, D, g)
        _same(topk(x, D), x, D)
    x = _tied(3, 2000, g)
    _same(_chunked(x, 2000, 4, 500), x, 2000)     # each list a whole chunk
    _same(_chunked(x, 1, 4, 500), x, 1)


def test_topk_plan_covers_rows(card):
    for B, D, k in ((256, 1 << 20, 1000), (1, 1 << 20, 1024), (1, 1 << 20, 100),
                    (256, 8192, 32), (8192, 8192, 128), (16, 20_000, 2048),
                    (1, 5, 5), (3, 200_000_000, 2048)):
        C, L, kstride = kernel.plan(B, D, k, 132)
        # a chunk fits one CTA's shared memory (csrc/topk.cu kMaxWords)
        assert (C - 1) * L < D <= C * L and L <= 45056
        assert kstride == (0 if C == 1 else (min(k, L) + 3) // 4 * 4)
