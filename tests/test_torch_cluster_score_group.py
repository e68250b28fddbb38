"""The cluster_score kernel's grouping pre-pass twin and its plain version
on the CPU.

`group_slots_ref` (the plain twin of csrc/cluster_score.cu's pre-pass,
which the card test holds the CUDA pre-pass to) is held exactly to a
numpy oracle written from the rule: bucket the in-range slots by block,
one bytes item per 256 rows for a run of fewer than 32 slots, the fewest
near-equal tiles of at most 128 slots (one item per 128 rows each) for a
longer run, GEMM items first. `cluster_score_ref` is held to JAX's
`cluster_score_pallas` in interpret mode on the patterns that pick the
kernel's two paths: every query selecting every block (the label pass's
chunks) and a query selecting one block twice; rtol 1e-5 and atol 1e-6
on unit-norm rows (two float32 dot-product orders).
"""

import numpy as np
import pytest
import torch

from repro.kernels.cluster_score.kernel import cluster_score_pallas
from repro_torch.kernels.cluster_score import (cluster_score,
                                               cluster_score_ref,
                                               group_slots_ref)


def _oracle(sel, U, cap):
    flat = sel.reshape(-1)
    runs = {u: [] for u in range(U)}
    for i, u in enumerate(flat.tolist()):
        if 0 <= u < U:
            runs[u].append(i)
    counts = np.array([len(runs[u]) for u in range(U)], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    order = np.array([i for u in range(U) for i in runs[u]], np.int32)
    gemm, small = [], []
    for u in range(U):
        n, s0 = len(runs[u]), int(starts[u])
        if n >= 32:
            m = (n + 127) // 128
            cuts = [s0 + (i * n) // m for i in range(m + 1)]
            for a, b in zip(cuts[:-1], cuts[1:]):
                gemm += [(u, a, b - a, r) for r in range(0, cap, 128)]
        elif n:
            small += [(u, s0, n, r) for r in range(0, cap, 256)]
    items = np.array(gemm + small, np.int32).reshape(-1, 4)
    return counts, starts, order, items


def _sel(seed, B, S, U):
    rng = np.random.default_rng(seed)
    sel = rng.integers(-2, U + 2, (B, S)).astype(np.int32)
    hot = rng.integers(0, U, 3)            # a few popular blocks
    for j, u in enumerate(hot):
        n = int(rng.integers(20, 3 * B // 2))
        rows = rng.choice(B * S, n, replace=False)
        sel.reshape(-1)[rows] = u
    return sel


@pytest.mark.parametrize("seed,B,S,U,cap", [(0, 64, 8, 40, 256),
                                            (1, 256, 32, 500, 256),
                                            (2, 300, 4, 3, 300),
                                            (3, 17, 5, 1, 7),
                                            (4, 512, 2, 9, 513),
                                            (5, 128, 3, 2000, 1)])
def test_group_slots_ref_matches_a_numpy_oracle(seed, B, S, U, cap):
    sel = _sel(seed, B, S, U)
    got = group_slots_ref(torch.from_numpy(sel), U, cap)
    for g, want in zip(got, _oracle(sel, U, cap)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), want)


def test_group_slots_ref_on_the_label_pattern():
    """512 queries x 64 blocks: 64 runs of 512 slots, four GEMM tiles of
    128 each, two 128-row items per tile, no bytes item."""
    sel = np.broadcast_to(np.arange(64, dtype=np.int32), (512, 64))
    counts, starts, order, items = group_slots_ref(torch.from_numpy(
        sel.copy()), 64, 256)
    assert (counts == 512).all() and items.shape == (512, 4)
    assert (items[:, 2] == 128).all()
    assert torch.equal(items[:8, 0], torch.zeros(8, dtype=torch.int32))
    np.testing.assert_array_equal(order.numpy(),
                                  _oracle(sel, 64, 256)[2])


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("pattern", ["shared", "duplicate"])
def test_plain_version_matches_jax_pallas(pattern):
    rng = np.random.default_rng(7)
    B, U, cap, dim = 40, 6, 16, 24
    q, blocks = _unit(rng, B, dim), _unit(rng, U, cap, dim)
    if pattern == "shared":              # every query selects every block
        sel = np.broadcast_to(np.arange(U, dtype=np.int32), (B, U)).copy()
    else:                                # and each picks one block twice
        sel = rng.integers(0, U, (B, 5)).astype(np.int32)
        sel[:, 3] = sel[:, 1]
        sel[:, 4] = 2
    want = np.asarray(cluster_score_pallas(q, blocks, sel, interpret=True))
    args = (torch.from_numpy(q), torch.from_numpy(blocks),
            torch.from_numpy(sel))
    got = cluster_score_ref(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(cluster_score(*args).numpy(), got)
    if pattern == "duplicate":
        np.testing.assert_array_equal(got[:, 1], got[:, 3])
