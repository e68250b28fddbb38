"""The block-major cluster_score kernel on the card: grouping invariance,
the selection patterns that pick each path, its tiling edges, CUDA-graph
capture, launch counting, and the grouping pre-pass against its plain
twin.

Marked `cuda`: the `card` fixture skips them where no GPU is present (it
decides inside the fixture, never at import). On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda \
        tests/test_torch_cuda_cluster_score.py

Tolerances against the plain version: rtol 1e-5, atol 1e-6 on unit-norm
rows (scores of size 1 or less), atol 1e-5 on unit-scale ones (the
kernel's one FMA chain against the einsum's own order); a (query, block)
pair's score is held bitwise across groupings, slots and paths.
"""

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.cluster_score import (cluster_score,
                                               cluster_score_ref,
                                               group_slots_ref)
from repro_torch.kernels.cluster_score import kernel as cs_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _unit(*shape, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(*shape, device="cuda", generator=g)
    return x / x.norm(dim=-1, keepdim=True)


def _close(out, q, blocks, sel, atol=1e-6):
    torch.testing.assert_close(out, cluster_score_ref(q, blocks, sel),
                               rtol=1e-5, atol=atol)


@pytest.mark.parametrize("cap,dim", [(256, 768), (7, 13)])
def test_grouping_invariance_bitwise(card, cap, dim):
    """Block 0 scored for groups of 1 and 3 queries (the bytes path) and
    of 64 and 512 (the GEMM path, 512 as four tiles of 128), every other
    query alone on a block of its own: each (query, block 0) score is
    bitwise the same in every group it is in."""
    B = 512
    q = _unit(B, dim)
    blocks = _unit(B + 1, cap, dim, seed=1)
    outs = {}
    for n in (1, 3, 64, 512):
        sel = torch.arange(B, dtype=torch.int32, device=card)[:, None] + 1
        sel[:n] = 0
        sel = sel.contiguous()
        outs[n] = cluster_score(q, blocks, sel)
        _close(outs[n], q, blocks, sel)
    for small in (1, 3, 64):
        for big in (n for n in outs if n > small):
            assert torch.equal(outs[small][:small].view(torch.int32),
                               outs[big][:small].view(torch.int32)), \
                (small, big)


def test_label_chunk_pattern(card):
    """Every query selects every block, as the label pass's chunks do:
    300 queries per block (tiles of 100), against the plain version and
    against q @ blocks^T."""
    B, U, cap, dim = 300, 5, 256, 96
    q, blocks = _unit(B, dim), _unit(U, cap, dim, seed=1)
    sel = torch.arange(U, dtype=torch.int32, device=card)[None].expand(
        B, U).contiguous()
    out = cluster_score(q, blocks, sel)
    _close(out, q, blocks, sel)
    torch.testing.assert_close(out.reshape(B, U * cap),
                               q @ blocks.reshape(U * cap, dim).T,
                               rtol=1e-5, atol=1e-6)


def test_popular_block_beside_singletons(card):
    """Block 7 picked by 202 slots (two GEMM tiles of 101) while the other
    slots pick blocks of one or two slots (the bytes path); its scores
    equal the same queries' in a group of 200 and alone."""
    B, S, U, cap, dim = 256, 4, 600, 64, 768
    q, blocks = _unit(B, dim), _unit(U, cap, dim, seed=1)
    sel = (torch.arange(B * S, device=card) % U).reshape(B, S).int()
    sel[:200, 2] = 7
    sel = sel.contiguous()
    out = cluster_score(q, blocks, sel)
    _close(out, q, blocks, sel)
    seven = torch.full((200, 1), 7, dtype=torch.int32, device=card)
    group = cluster_score(q[:200].contiguous(), blocks, seven)
    alone = cluster_score(q[:1].contiguous(), blocks, seven[:1])
    assert torch.equal(out[:200, 2].view(torch.int32),
                       group[:, 0].view(torch.int32))
    assert torch.equal(alone[0, 0].view(torch.int32),
                       out[0, 2].view(torch.int32))


def test_a_query_selecting_a_block_twice(card):
    """Duplicate slots of one query are their own output rows, bitwise
    the same: query 0 picks block 1 twice (a bytes tile of 2 slots), the
    other 39 queries pick block 0 twice (a GEMM tile of 78)."""
    B, cap, dim = 40, 256, 768
    q, blocks = _unit(B, dim), _unit(3, cap, dim, seed=1)
    sel = torch.tensor([[1, 2, 1]] + [[0, 0, 2]] * (B - 1), dtype=torch.int32,
                       device=card)
    out = cluster_score(q, blocks, sel)
    _close(out, q, blocks, sel)
    assert torch.equal(out[0, 0].view(torch.int32),
                       out[0, 2].view(torch.int32))
    assert torch.equal(out[1:, 0].view(torch.int32),
                       out[1:, 1].view(torch.int32))


def test_out_of_range_positions_score_nan(card):
    B, S, U, cap, dim = 50, 6, 9, 40, 64
    q, blocks = _unit(B, dim), _unit(U, cap, dim, seed=1)
    g = torch.Generator(device="cuda").manual_seed(2)
    sel = torch.randint(0, U, (B, S), device=card, generator=g,
                        dtype=torch.int32)
    sel[:, 0] = 3                                   # a GEMM tile too
    bad = torch.zeros_like(sel, dtype=torch.bool)
    bad[::3, 1], bad[1::4, 4] = True, True
    sel[::3, 1] = -1
    sel[1::4, 4] = U + 2
    out = cluster_score(q, blocks, sel)
    torch.cuda.synchronize()
    assert torch.isnan(out[bad]).all()
    assert not torch.isnan(out[~bad]).any()
    ok = sel.clamp(0, U - 1)
    torch.testing.assert_close(out[~bad], cluster_score_ref(q, blocks,
                                                            ok)[~bad],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,dim,U,cap,S", [(5, 13, 1, 7, 3),
                                           (40, 30, 1, 33, 1),
                                           (9, 770, 4, 300, 5)])
def test_odd_shapes(card, B, dim, U, cap, S):
    """Odd cap and dim, dim not a multiple of 4 (the 4-byte copies), U 1
    (every slot on one block: bytes at 15 slots, GEMM at 40), cap 300 at
    dim 770 (two bytes row items; three GEMM ones)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(B, dim, device=card, generator=g) / dim ** 0.25
    blocks = torch.randn(U, cap, dim, device=card, generator=g) / dim ** 0.25
    sel = torch.randint(0, U, (B, S), device=card, generator=g,
                        dtype=torch.int32)
    out = cluster_score(q, blocks, sel)
    _close(out, q, blocks, sel, atol=1e-5)
    if U == 4:              # every slot on block 2: a GEMM tile of 45
        sel = torch.full((B, S), 2, dtype=torch.int32, device=card)
        out = cluster_score(q, blocks, sel)
        _close(out, q, blocks, sel, atol=1e-5)


def test_capture_and_replay_in_a_cuda_graph(card):
    """The call makes no host sync: it is captured in a CUDA graph, and a
    replay after new queries and positions are copied into the captured
    inputs scores them."""
    B, S, U, cap, dim = 64, 8, 100, 256, 768
    q, blocks = _unit(B, dim), _unit(U, cap, dim, seed=1)
    g = torch.Generator(device="cuda").manual_seed(4)
    sel = torch.randint(0, U, (B, S), device=card, generator=g,
                        dtype=torch.int32)
    sel[:, 0] = 5
    cluster_score(q, blocks, sel)                   # build, warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cluster_score(q, blocks, sel)
    q.copy_(_unit(B, dim, seed=5))
    sel.copy_(torch.randint(0, U, (B, S), device=card, generator=g,
                            dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    _close(out, q, blocks, sel)
    assert torch.equal(out.view(torch.int32),
                       cluster_score(q, blocks, sel).view(torch.int32))


def test_launch_count_rises_by_one_per_call(card):
    q, blocks = _unit(600, 32), _unit(3, 16, 32, seed=1)
    for sel in (torch.zeros(600, 1, dtype=torch.int32, device=card),
                torch.arange(3, dtype=torch.int32,
                             device=card)[None].expand(600, 3).contiguous(),
                torch.full((600, 2), -1, dtype=torch.int32, device=card)):
        before = kernels.LAUNCHES["cluster_score"]
        cluster_score(q, blocks, sel)
        assert kernels.LAUNCHES["cluster_score"] == before + 1


@pytest.mark.parametrize("pattern", ["mixed", "label"])
def test_group_prepass_matches_its_twin(card, pattern):
    """The CUDA pre-pass against group_slots_ref: counts, starts and work
    items equal, each block's run of slots the same multiset."""
    g = torch.Generator(device="cuda").manual_seed(6)
    if pattern == "mixed":           # singletons, a popular block, NaN slots
        U, cap = 700, 300
        sel = torch.randint(-3, U + 3, (256, 32), device=card, generator=g,
                            dtype=torch.int32)
        sel[:150, 5] = 11
        sel[:40, 6] = 12
    else:
        U, cap = 64, 256
        sel = torch.arange(U, dtype=torch.int32, device=card)[None].expand(
            512, U)
    sel = sel.contiguous()
    counts, starts, order, items = cs_kernel.group_slots_cuda(sel, U, cap)
    r_counts, r_starts, r_order, r_items = group_slots_ref(sel, U, cap)
    assert torch.equal(counts.cpu(), r_counts)
    assert torch.equal(starts.cpu(), r_starts)
    assert torch.equal(items.cpu(), r_items)
    order = order.cpu()
    for u in torch.nonzero(r_counts).flatten().tolist():
        a, n = int(r_starts[u]), int(r_counts[u])
        assert torch.equal(order[a:a + n].sort().values, r_order[a:a + n])
