"""The plain versions of the port's topk and bin_overlap kernels against
the JAX package, on numpy inputs.

topk_ref is held bitwise (values and ids) to `jax.lax.top_k` and to
`topk_pallas` in interpret mode on the hazards the kernel must match:
massive exact ties, all-equal rows, -inf rows, k == D, k == 0, -0.0
beside +0.0 (lax.top_k ranks -0.0 below +0.0) and a row-strided view
(the Pallas kernel's ids at -inf entries excepted, see its test).
The chunked CUDA kernel's exactness argument (the top k of a row lie in
the union of its chunks' top k, ties resolved by index) is pinned on
topk_ref over hypothesis-drawn rows.
bin_overlap_ref is held to the JAX package's segment_sum form
(`core/bins.overlap_features`): P exact, Q bitwise, because both add a
slot's scores in rank order. The Pallas bin_overlap kernel sums through
one-hot matrix products, another order, so Q is held to it at rtol
1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import as_tensor

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:
    from _hypothesis_stub import given, settings
    from _hypothesis_stub import strategies as st

from repro.core import bins as jbins
from repro.kernels.bin_overlap.kernel import bin_overlap_pallas
from repro.kernels.topk.kernel import topk_pallas
from repro_torch import kernels
from repro_torch.core import bins as tbins
from repro_torch.core import fusion as tfusion
from repro_torch.kernels.bin_overlap import bin_overlap, bin_overlap_ref
from repro_torch.kernels.topk import topk, topk_ref


def _rows(case):
    """(x (B, D) float32, k) for one hazard."""
    rng = np.random.default_rng(3)
    if case == "massive_ties":          # a fused row: mostly exact zeros
        x = np.zeros((4, 4096), np.float32)
        for b, n_valid in enumerate((3, 40, 400, 4000)):
            at = rng.choice(4096, n_valid, replace=False)
            x[b, at] = rng.random(n_valid).astype(np.float32)
        return x, 64
    if case == "all_equal":
        return np.full((3, 257), 0.25, np.float32), 100
    if case == "neg_inf":               # the Stage-II budget mask
        x = rng.random((5, 32)).astype(np.float32)
        x[:, ::2] = -np.inf
        x[2] = -np.inf
        return x, 20
    if case == "k_eq_D":
        x = rng.integers(-2, 3, (4, 33)).astype(np.float32)
        x[1, :5] = -np.inf
        return x, 33
    if case == "k_zero":
        return rng.random((2, 9)).astype(np.float32), 0
    if case == "signed_zero":
        x = rng.choice(np.asarray([0.0, -0.0, 1.0, -1.0], np.float32),
                       (6, 64))
        x[0] = -0.0
        x[1, ::2] = 0.0
        x[1, 1::2] = -0.0
        return x, 40
    raise ValueError(case)


def _same(got, want):
    """Bitwise equal values (signs of zeros included) and equal ids."""
    (tv, ti), (jv, ji) = got, want
    tv, ti = tv.numpy(), ti.numpy()
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv.view(np.uint32), jv.view(np.uint32))


@pytest.mark.parametrize("case", ["massive_ties", "all_equal", "neg_inf",
                                  "k_eq_D", "k_zero", "signed_zero"])
def test_topk_ref_bitwise_vs_lax_top_k(case):
    x, k = _rows(case)
    _same(topk_ref(as_tensor(x), k), jax.lax.top_k(jnp.asarray(x), k))


def test_topk_ref_reads_a_strided_view_like_lax_top_k():
    """fused[:, :n_docs]: rows of n_docs entries at a stride of n_docs + 1,
    the dump column holding the largest values."""
    x, k = _rows("massive_ties")
    buf = np.concatenate([x, np.full((x.shape[0], 1), 9.0, np.float32)], 1)
    view = as_tensor(buf)[:, :x.shape[1]]
    assert view.stride() == (x.shape[1] + 1, 1)
    _same(topk_ref(view, k), jax.lax.top_k(jnp.asarray(x), k))
    _same(tfusion.topk_desc_index_asc(view, k),
          jax.lax.top_k(jnp.asarray(x), k))


def test_topk_ref_bitwise_vs_topk_pallas_interpret():
    """The Pallas kernel starts its running best at (-inf, index 0), so a
    -inf entry that reaches the top-k comes back with index 0, not its
    own as under lax.top_k (and the port): there the ids are compared at
    finite values only."""
    for case in ("massive_ties", "all_equal", "neg_inf", "k_eq_D",
                 "signed_zero"):
        x, k = _rows(case)
        tv, ti = topk_ref(as_tensor(x), k)
        pv, pi = topk_pallas(jnp.asarray(x), k, block_d=16, interpret=True)
        pv, pi = np.asarray(pv), np.asarray(pi)
        np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                      pv.view(np.uint32), err_msg=case)
        finite = np.isfinite(pv)
        assert finite.mean() > 0.5, case
        np.testing.assert_array_equal(ti.numpy()[finite], pi[finite],
                                      err_msg=case)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_topk_ref_of_chunk_topks_is_the_row_topk(seed):
    """What the chunked kernel relies on: cut a row into C chunks of L
    (L rounded up to 4, the last chunk shorter), take topk_ref of each
    chunk at k' = min(k, its length), map the indices to the row's, and
    topk_ref of the concatenated lists, whose ties keep (chunk, index)
    order, is topk_ref of the whole row, bit for bit. Rows of few values
    (heavy ties), +-0.0 and -inf, and several chunk counts."""
    rng = np.random.default_rng(seed)
    B, D = int(rng.integers(1, 4)), int(rng.integers(1, 700))
    k = int(rng.integers(1, D + 1))
    palette = np.asarray([0.0, -0.0, -np.inf, 1.0, -1.0, 0.5],
                         np.float32)[:int(rng.integers(2, 7))]
    x = rng.choice(palette, (B, D))
    noisy = rng.random((B, D)) < rng.random()
    x[noisy] = rng.standard_normal(int(noisy.sum())).astype(np.float32)
    xt = as_tensor(x)
    wv, wi = topk_ref(xt, k)
    for C in sorted({1, 2, 3, 5, 8, int(rng.integers(1, D + 1))}):
        L = (-(-D // C) + 3) // 4 * 4
        vs, ix = [], []
        for start in range(0, D, L):
            chunk = xt[:, start:start + L]
            v, i = topk_ref(chunk, min(k, chunk.shape[1]))
            vs.append(v)
            ix.append(i + start)
        cv, pos = topk_ref(torch.cat(vs, 1), k)
        ci = torch.cat(ix, 1).gather(1, pos)
        assert torch.equal(ci, wi), (seed, C)
        assert torch.equal(cv.view(torch.int32), wv.view(torch.int32))


def _overlap_inputs(B=5, k=64, N=12, v=4, seed=0):
    rng = np.random.default_rng(seed)
    D = 300
    ids = np.stack([rng.choice(D, k, replace=False)
                    for _ in range(B)]).astype(np.int32)
    doc_cluster = rng.integers(0, N, D).astype(np.int32)
    scores = rng.standard_normal((B, k)).astype(np.float32) * 100.0
    scores[:, ::7] = -0.0
    bin_ids = np.searchsorted(np.asarray([4, 10, 30, k]), np.arange(k),
                              side="right").astype(np.int32)
    return ids, scores, doc_cluster, bin_ids, N, v


def test_bin_overlap_ref_bitwise_vs_jax_segment_sum():
    ids, scores, doc_cluster, bin_ids, N, v = _overlap_inputs()
    jP, jQ = jbins.overlap_features(jnp.asarray(ids), jnp.asarray(scores),
                                    jnp.asarray(doc_cluster), N,
                                    jnp.asarray(bin_ids), v)
    tP, tQ = tbins.overlap_features(as_tensor(ids), as_tensor(scores),
                                    as_tensor(doc_cluster), N,
                                    as_tensor(bin_ids), v)
    np.testing.assert_array_equal(tP.numpy(), np.asarray(jP))
    np.testing.assert_array_equal(tQ.numpy().view(np.uint32),
                                  np.asarray(jQ).view(np.uint32))
    assert (tP.numpy() > 1).any()          # runs of more than one result


def test_bin_overlap_ref_vs_pallas_interpret():
    ids, scores, doc_cluster, bin_ids, N, v = _overlap_inputs(seed=1)
    c_of = doc_cluster[ids]
    bins2 = np.broadcast_to(bin_ids, ids.shape).copy()
    jP, jQ = bin_overlap_pallas(jnp.asarray(c_of), jnp.asarray(bins2),
                                jnp.asarray(scores), n_clusters=N, v=v,
                                interpret=True)
    for b in (as_tensor(bin_ids), as_tensor(bins2)):     # (k,) and (B, k)
        tP, tQ = bin_overlap_ref(as_tensor(c_of), b, as_tensor(scores),
                                 n_clusters=N, v=v)
        np.testing.assert_array_equal(tP.numpy(), np.asarray(jP))
        np.testing.assert_allclose(tQ.numpy(), np.asarray(jQ), rtol=1e-6,
                                   atol=1e-6)


def test_cpu_wrappers_take_the_plain_versions_without_launches():
    kernels.reset_launches()
    x, k = _rows("massive_ties")
    for a, b in zip(topk(as_tensor(x), k), topk_ref(as_tensor(x), k)):
        assert torch.equal(a, b)
    ids, scores, doc_cluster, bin_ids, N, v = _overlap_inputs()
    c_of = as_tensor(doc_cluster[ids])
    P, Q = bin_overlap(c_of, as_tensor(bin_ids), as_tensor(scores),
                       n_clusters=N, v=v)
    rP, rQ = bin_overlap_ref(c_of, as_tensor(bin_ids), as_tensor(scores),
                             n_clusters=N, v=v)
    assert torch.equal(P, rP) and torch.equal(Q, rQ)
    assert P.shape == (ids.shape[0], N, v)
    assert kernels.LAUNCHES["topk"] == kernels.LAUNCHES["bin_overlap"] == 0


def test_topk_rejects_k_out_of_range():
    x = torch.zeros(2, 5)
    for k in (-1, 6):
        with pytest.raises(ValueError, match="out of range"):
            topk(x, k)
    v, i = topk(torch.zeros(3, 4, 7), 2)            # leading dims kept
    assert v.shape == i.shape == (3, 4, 2) and i.dtype == torch.int64
