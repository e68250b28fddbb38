"""The bin_overlap and embedding_bag kernels (csrc/bin_overlap.cu,
csrc/embedding_bag.cu) against their plain versions on the card, at the
edges of their tilings and at the main path's shapes.

Marked `cuda`: the `card` fixture skips them where no GPU is present (it
decides inside the fixture, never at import). On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_bags.py

Tolerances: bitwise throughout. bin_overlap is held to the plain version
on the CPU (its scatter_add_ adds a row's entries in index order; on the
card the plain version adds with atomics); results whose slot falls
outside [0, N*v) are dropped by the kernel, so the reference maps them
to an extra cluster N and leaves that cluster out. embedding_bag adds in
float32 in ascending h and rounds once on store, as the plain version
does.
"""

import threading

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.bin_overlap import bin_overlap, bin_overlap_ref
from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref

pytestmark = pytest.mark.cuda

EDGES = [10, 25, 50, 100, 200, 500, 1000]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _gen(seed=0):
    return torch.Generator(device="cuda").manual_seed(seed)


def _rank_bins(k, B=None):
    bins = torch.bucketize(torch.arange(k), torch.tensor(EDGES),
                           right=True).int().clamp(max=len(EDGES) - 1)
    return bins if B is None else bins.expand(B, k).contiguous()


def _overlap_bitwise(c_of, bins, scores, N, v):
    """One launch, held bitwise to the CPU plain version; returns P."""
    before = kernels.LAUNCHES["bin_overlap"]
    P, Q = bin_overlap(c_of, bins, scores, n_clusters=N, v=v)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bin_overlap"] == before + 1
    c = c_of.cpu()
    dropped = (c < 0) | (c >= N)
    rP, rQ = bin_overlap_ref(torch.where(dropped, N, c), bins.cpu(),
                             scores.cpu(), n_clusters=N + 1, v=v)
    assert P.shape == Q.shape == (c_of.shape[0], N, v)
    assert torch.equal(P.cpu(), rP[:, :N])
    assert torch.equal(Q.cpu().view(torch.int32), rQ[:, :N].view(torch.int32))
    return P


@pytest.mark.parametrize("per_query_bins", [False, True])
@pytest.mark.parametrize("B, N", [(1, 4096), (256, 8192)])
def test_bin_overlap_over_k(card, B, N, per_query_bins):
    """The recsys query's (1, k) rows at N 4096 and Stage I's (256, k) at
    N 8192, v 7, k from 1 to the kernel's 2048, with runs of equal
    clusters; shared (k,) and per-query (B, k) bins."""
    g = _gen()
    for k in (1, 7, 1000, 1024, 2048):
        c_of = torch.randint(0, N, (B, k), device=card, generator=g,
                             dtype=torch.int32)
        c_of[:, k // 2:] = c_of[:, :k - k // 2].clone()
        bins = _rank_bins(k, B if per_query_bins else None).to(card)
        scores = torch.rand(B, k, device=card, generator=g)
        P = _overlap_bitwise(c_of, bins, scores, N, 7)
        assert k < 7 or (P > 1).any()


def test_bin_overlap_odd_slot_counts_and_tile_edges(card):
    """N * v not a multiple of 4 (scalar stores) and a multiple (16-byte
    stores); results on the slots at every multiple of 256 and one each
    side (each tile edge, whatever tile the launch picks), the first and
    the last slot."""
    g = _gen(1)
    for B, N, v in ((1, 4095, 7), (3, 1001, 3), (256, 8191, 7),
                    (2, 4096, 7), (1, 5, 1)):
        n_slots = N * v
        edges = torch.arange(0, n_slots + 256, 256)
        slots = torch.cat([edges - 1, edges, edges + 1,
                           torch.tensor([0, n_slots - 1])])
        slots = slots[(slots >= 0) & (slots < n_slots)]
        k = min(2048, slots.numel())
        pick = slots[torch.randperm(slots.numel())[:k]]
        pick = torch.stack([pick.roll(i) for i in range(B)]).to(card)
        c_of = (pick // v).int().contiguous()
        bins = (pick % v).int().contiguous()
        scores = torch.randn(B, k, device=card, generator=g)
        _overlap_bitwise(c_of, bins, scores, N, v)


def test_bin_overlap_one_slot_dropped_ids_and_order(card):
    """All k results in one slot; cluster ids below 0 and at or above N
    (dropped); sums whose value depends on their order (1e8, 1, -1e8 in
    rank order gives 0, not 1) and -0.0 scores (0.0 + -0.0 is +0.0)."""
    g = _gen(2)
    N, v, k = 8192, 7, 2048
    for B in (1, 4):
        c_of = torch.full((B, k), 77, dtype=torch.int32, device=card)
        bins = torch.full((k,), 3, dtype=torch.int32, device=card)
        scores = torch.rand(B, k, device=card, generator=g)
        P = _overlap_bitwise(c_of, bins, scores, N, v)
        assert (P[:, 77, 3] == k).all() and P.sum() == B * k
    k = 1000
    c_of = torch.randint(-3, N + 3, (256, k), device=card, generator=g,
                         dtype=torch.int32)
    c_of[:, ::5] = torch.tensor([-1, N, -2 ** 31, 2 ** 31 - 1, N + 1],
                                dtype=torch.int32).repeat(k // 25)[:200]
    scores = torch.rand(256, k, device=card, generator=g)
    _overlap_bitwise(c_of, _rank_bins(k).to(card), scores, N, v)
    # order-dependent sums and signed zeros, per-query bins
    c_of = torch.randint(0, 64, (8, k), device=card, generator=g,
                         dtype=torch.int32)
    c_of[:, :3] = 5
    scores = torch.rand(8, k, device=card, generator=g)
    scores[:, :3] = torch.tensor([1e8, 1.0, -1e8])
    scores[:, 3::7] = -0.0
    bins = torch.zeros(8, k, dtype=torch.int32, device=card)
    P = _overlap_bitwise(c_of, bins, scores, 64, 1)
    c_of[:, :] = 9
    _overlap_bitwise(c_of, bins, torch.full_like(scores, -0.0), 64, 1)


def _bag_bitwise(table, idx):
    before = kernels.LAUNCHES["embedding_bag"]
    out = embedding_bag(table, idx)
    assert kernels.LAUNCHES["embedding_bag"] == before + 1
    ref = embedding_bag_ref(table, idx)
    assert out.shape == ref.shape and out.dtype == table.dtype
    assert torch.equal(out.view(torch.int16 if out.dtype == torch.bfloat16
                                else torch.int32),
                       ref.view(torch.int16 if ref.dtype == torch.bfloat16
                                else torch.int32))


@pytest.mark.parametrize("hot", [0, 1, 2, 5, 20, 21, 40, 41, 100])
def test_embedding_bag_over_hot_and_d(card, hot):
    """float32 at d in {1, 3, 4, 32, 33, 128} (scalar and float4 rows,
    one lane to a warp a bag row); B 1, 777 and 2048 (a warp per bag,
    its slices' chunks ending inside and at the edge of a bag) and 2049
    and 16,129 (a bag row's lanes walk its positions); heavy-tailed ids
    as the recsys traffic draws them."""
    g = _gen(hot)
    V = 5000
    for d in (1, 3, 4, 32, 33, 128):
        table = torch.randn(V, d, device=card, generator=g)
        for B in (1, 777, 2048, 2049, 16129):
            idx = (torch.rand(B, hot, device=card, generator=g) ** 4
                   * V).int()
            _bag_bitwise(table, idx)


def test_embedding_bag_bfloat16_and_unaligned_views(card):
    """bfloat16 tables; a float32 table that starts 4 bytes into its
    storage (no float4 rows); index views that start 4, 8 and 12 bytes
    past a 16-byte boundary; a warp per bag (1111 bags) and a bag row's
    lanes (17,001)."""
    g = _gen(3)
    V = 3000
    for d in (1, 3, 4, 32, 33, 128):
        table = torch.randn(V, d, device=card, generator=g)
        for hot, B in ((1, 1111), (2, 1111), (20, 1111), (9, 17001),
                       (40, 17001), (41, 17001)):
            idx = torch.randint(0, V - 1, (B, hot), device=card,
                                generator=g, dtype=torch.int32)
            _bag_bitwise(table.bfloat16(), idx)
            odd = table.view(-1)[1:1 + (V - 1) * d].view(V - 1, d)
            _bag_bitwise(odd, idx)
            flat = torch.empty(idx.numel() + 3, dtype=torch.int32,
                               device=card)
            for off in (1, 2, 3):
                view = flat[off:off + idx.numel()].view_as(idx)
                view.copy_(idx)
                _bag_bitwise(table, view)


def test_embedding_bag_main_path_shapes(card):
    """The guide (2^20, 2, 1), the candidate tower (2^20, 2, 32), the
    bulk wide bag (262,144, 40, 1) and the user tower (1, 20, 32), over
    uniform ids of a 4M-row d-1 table and a 1M-row d-32 table."""
    g = _gen(4)
    wide = torch.randn(4_000_000, 1, device=card, generator=g)
    deep = torch.randn(1_000_000, 32, device=card, generator=g)
    for table, (B, hot) in ((wide, (1 << 20, 2)), (deep, (1 << 20, 2)),
                            (wide, (262144, 40)), (deep, (1, 20))):
        idx = torch.randint(0, table.shape[0], (B, hot), device=card,
                            generator=g, dtype=torch.int32)
        _bag_bitwise(table, idx)


@pytest.mark.parametrize("bad", [-1, "V"])
def test_embedding_bag_bad_index_raises_on_the_card(card, bad):
    """-1 and V raise IndexError before the op returns, wherever they
    stand: the last index of a 2^20-bag call, the first or last index
    of a middle bag, in grids of a bag row's lanes (hot 2, 40) and of a
    warp per bag (hot 100 at d 1, hot 3 at d 4); the next good call
    still succeeds (each call has its own error word). A table with no
    rows raises without a launch."""
    g = _gen(5)
    for V, B, hot, d in ((4_000_000, 1 << 20, 2, 1), (5000, 30000, 40, 1),
                         (5000, 3000, 40, 32), (5000, 700, 100, 1),
                         (5000, 64, 3, 4)):
        table = torch.randn(V, d, device=card, generator=g)
        value = V if bad == "V" else bad
        for where in ((B - 1, hot - 1), (B // 2, 0)):
            idx = torch.randint(0, V, (B, hot), device=card, generator=g,
                                dtype=torch.int32)
            idx[where] = value
            with pytest.raises(IndexError, match="outside the table"):
                embedding_bag(table, idx)
            idx[where] = V - 1
            _bag_bitwise(table, idx)
    with pytest.raises(IndexError, match="outside the table"):
        embedding_bag(torch.empty(0, 4, device=card),
                      torch.zeros(3, 2, dtype=torch.int32, device=card))


def test_embedding_bag_two_threads_keep_their_own_errors(card):
    """Two threads, each on its own stream, bag 200 times at once on one
    card; one thread's indices hold V. Only that thread raises, every
    time, and the other thread's outputs are bitwise the plain version's
    (each call reads back its own error word, none is shared)."""
    g = _gen(6)
    V, B, hot = 100_000, 65536, 8
    table = torch.randn(V, 1, device=card, generator=g)
    good = torch.randint(0, V, (B, hot), device=card, generator=g,
                         dtype=torch.int32)
    bad = good.clone()
    bad[B // 3, hot // 2] = V
    ref = embedding_bag_ref(table, good)
    torch.cuda.synchronize()
    start = threading.Barrier(2)
    outcome = {"bad": [], "good": []}

    def run(key, idx):
        stream = torch.cuda.Stream(card)
        start.wait()
        with torch.cuda.stream(stream):
            for _ in range(200):
                try:
                    out = embedding_bag(table, idx)
                    outcome[key].append(
                        torch.equal(out.view(torch.int32),
                                    ref.view(torch.int32)))
                except IndexError as e:
                    outcome[key].append(str(e))

    threads = [threading.Thread(target=run, args=("bad", bad)),
               threading.Thread(target=run, args=("good", good))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    assert not any(th.is_alive() for th in threads)
    assert outcome["good"] == [True] * 200
    assert len(outcome["bad"]) == 200
    assert all(isinstance(r, str) and f"index {V} is outside" in r
               for r in outcome["bad"])


@pytest.mark.parametrize("B, d, dtype", [
    (8192, 1, torch.float32),      # wide-deep full's wide bag, one rank of 4
    (512, 1, torch.float32),       # its serve batch
    (64, 32, torch.float32),       # the warp-per-bag path, float4 columns
    (3000, 3, torch.bfloat16)])
def test_embedding_bag_row_slice_with_a_zero_row(card, B, d, dtype):
    """The row-sharded wide bag: the rank's slices of 40 fields side by
    side (wide-deep full()'s rows over 4 ranks) and one zero row after
    them; an id in its field's slice reads its row there, every other id
    the zero row. Bitwise the plain version, one launch; its backward
    adds each id's gradient to the row it read."""
    from repro_torch.configs import get_config
    from repro_torch.models.recsys import _padded_rows
    g = _gen(3)
    rows = [_padded_rows(r) for r in get_config("wide-deep").table_sizes]
    n = torch.tensor([r // 4 for r in rows], device="cuda")
    zero = int(n.sum())
    table = torch.cat([torch.randn((zero, d), generator=g, device="cuda"),
                       torch.zeros((1, d), device="cuda")]).to(dtype)
    ids = torch.stack([torch.randint(0, r, (B,), generator=g, device="cuda")
                       for r in rows], 1)
    local = ids - 1 * n                  # rank 1's slice
    mine = (local >= 0) & (local < n)
    off = torch.cumsum(n, 0) - n
    idx = torch.where(mine, local + off, zero).int().contiguous()
    assert 0 < int(mine.sum()) < mine.numel()
    before = kernels.LAUNCHES["embedding_bag"]
    out = embedding_bag(table, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["embedding_bag"] == before + 1
    ref = embedding_bag_ref(table, idx)
    assert torch.equal(out.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       ref.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32))
    if dtype == torch.float32:
        tk = table.clone().requires_grad_()
        gout = torch.randn((B, d), generator=g, device="cuda")
        (gk,) = torch.autograd.grad(embedding_bag(tk, idx), tk, gout)
        want = torch.zeros_like(table).index_add_(
            0, idx.reshape(-1).long(),
            gout[:, None, :].expand(B, idx.shape[1], d).reshape(-1, d))
        torch.testing.assert_close(gk, want, rtol=1e-5, atol=1e-5)
