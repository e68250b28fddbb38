"""Module parity of repro_torch's configs, data and build-side numerics
against the JAX package on the CPU: the same numpy inputs through both.
(The query stages are held to it in test_torch_stages.py.)

Tolerances, each with its reason:
  * configs, synthetic data, SparseIndex arrays, cluster tables, top-k
    ties, fusion ids: exact — integer work, or float work in the same
    order.
  * kmeans assignments, PQ codes: exact on data without near-ties of the
    distances they argmin; centroids 1e-5 (sums in another order).
  * fused scores 1e-6: the same min-max arithmetic.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_tensor as _t
from repro.configs import get_config
from repro.core import fusion as jfusion
from repro.core import kmeans as jkm
from repro.core import quant as jquant
from repro.core import sparse as jsparse
from repro.data import synth_corpus as jax_synth_corpus
from repro.data import synth_queries as jax_synth_queries
from repro_torch.configs import clusd_msmarco
from repro_torch.core import clusd as tcl
from repro_torch.core import fusion as tfusion
from repro_torch.core import kmeans as tkm
from repro_torch.core import quant as tquant
from repro_torch.core import sparse as tsparse
from repro_torch.data import synth_corpus, synth_queries



def test_configs_copy_the_jax_dataclass():
    for variant in ("full", "smoke"):
        j = get_config("clusd-msmarco", variant)
        t = getattr(clusd_msmarco, variant)()
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        for prop in ("v_bins", "n_candidates_total", "cluster_cap"):
            assert getattr(j, prop) == getattr(t, prop), prop
    full = clusd_msmarco.full()
    assert 1 + full.u_bins + 2 * full.v_bins == 21


def test_synthetic_corpus_and_queries_match_jax():
    jc = jax_synth_corpus(4, 300, 16, 200)
    tc = synth_corpus(4, 300, 16, 200)
    np.testing.assert_array_equal(np.asarray(jc.embeddings), tc.embeddings)
    np.testing.assert_array_equal(jc.doc_terms, tc.doc_terms)
    np.testing.assert_array_equal(jc.doc_weights, tc.doc_weights)
    jq, tq = jax_synth_queries(5, jc, 20), synth_queries(5, tc, 20)
    for f in ("q_dense", "q_terms", "q_weights", "rel_doc"):
        np.testing.assert_array_equal(np.asarray(getattr(jq, f)),
                                      getattr(tq, f), err_msg=f)


@pytest.mark.parametrize("max_postings", [256, 7])
def test_sparse_index_build_bitwise(max_postings):
    rng = np.random.default_rng(max_postings)
    D, T, V = 400, 12, 60
    terms = rng.integers(-1, V, (D, T)).astype(np.int32)     # pads + dups
    # few distinct weights: many (weight, doc) ties, some zero weights
    weights = rng.choice(np.float32([0.0, 0.5, 1.0, 2.25]), (D, T))
    j = jsparse.SparseIndex.build(terms, weights, V, max_postings)
    pd, pw, truncated = tsparse.SparseIndex.build_arrays(terms, weights, V,
                                                         max_postings)
    np.testing.assert_array_equal(pd, np.asarray(j.postings_docs))
    np.testing.assert_array_equal(pw, np.asarray(j.postings_weights))
    assert truncated == j.truncated_postings


def test_topk_tie_rule_matches_lax_top_k():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 4, (6, 50)).astype(np.float32)   # heavy ties
    x[0, :] = 0.0
    x[1, ::3] = -np.inf
    for k in (1, 7, 50):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tfusion.topk_desc_index_asc(_t(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_kmeans_assignments_match_given_jax_init():
    rng = np.random.default_rng(2)
    centers = 6.0 * rng.standard_normal((12, 8)).astype(np.float32)
    X = (centers[rng.integers(0, 12, 600)]
         + 0.3 * rng.standard_normal((600, 8))).astype(np.float32)
    key = jax.random.key(3)
    init = X[np.asarray(jax.random.choice(key, 600, (12,), replace=False))]
    jc, ja = jkm.kmeans(key, jnp.asarray(X), 12, iters=6)
    tc, ta = tkm.kmeans(X, 12, 6, init=init, device="cpu")
    assert (np.bincount(ta.numpy(), minlength=12) > 0).all()  # none emptied
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)


def test_kmeans_cluster_sums_match_float64_segment_sum():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((700, 6)).astype(np.float32)
    assign = rng.integers(0, 9, 700)
    assign[assign == 4] = 3                          # cluster 4 left empty
    want = np.zeros((9, 6))
    np.add.at(want, assign, X.astype(np.float64))
    got = tkm._cluster_sums(_t(X), torch.from_numpy(assign), 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    assert not got[4].any()


@pytest.mark.parametrize("with_vectors", [True, False])
def test_build_cluster_table_matches_jax(with_vectors):
    rng = np.random.default_rng(4)
    N, cap, D = 10, 8, 70                    # lopsided: overflow guaranteed
    X = rng.standard_normal((D, 6)).astype(np.float32)
    C = rng.standard_normal((N, 6)).astype(np.float32)
    assign = np.where(rng.random(D) < 0.5, 0, rng.integers(0, N, D))
    args = (X, C) if with_vectors else (None, None)
    jt, jd = jkm.build_cluster_table(assign, N, cap, *args)
    tt, td = tkm.build_cluster_table(assign, N, cap, *args)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    np.testing.assert_array_equal(td, np.asarray(jd))


def test_pq_encode_codes_equal():
    rng = np.random.default_rng(5)
    books = rng.standard_normal((8, 256, 4)).astype(np.float32)
    X = rng.standard_normal((500, 32)).astype(np.float32)
    want = np.asarray(jquant.pq_encode(jnp.asarray(books), X))
    got = tquant.pq_encode(_t(books), X).numpy()
    np.testing.assert_array_equal(got, want)


def test_stage2_untrained_fallback_takes_stage1_order():
    cfg = clusd_msmarco.smoke()
    index = tcl.CluSDIndex(torch.zeros(4, 2), torch.zeros(4, 2), torch.zeros(3),
                           torch.zeros(4, 2), torch.zeros(4, 2), None, None)
    cand = torch.arange(16, dtype=torch.int32).repeat(2, 1)
    out = tcl.stage2_select(cfg, index, cand, None)
    np.testing.assert_array_equal(out["sel_ids"].numpy(),
                                  np.tile(np.arange(8), (2, 1)))
    assert out["sel_mask"].all()


@pytest.mark.parametrize("method", ["interp", "rrf"])
def test_fuse_topk_matches_jax_with_exact_zero_ties(method):
    rng = np.random.default_rng(6)
    B, n_docs, Ks, Kd, k = 4, 60, 12, 20, 40   # k > union: exact-0 ties
    sid = np.stack([rng.permutation(n_docs)[:Ks] for _ in range(B)])
    did = np.stack([rng.permutation(n_docs)[:Kd] for _ in range(B)])
    ss = rng.random((B, Ks)).astype(np.float32)
    ds = rng.standard_normal((B, Kd)).astype(np.float32)
    dm = rng.random((B, Kd)) < 0.7
    ss[0, :3] = ss[0, 3]                          # score ties
    sid, did = sid.astype(np.int32), did.astype(np.int32)
    jids, jsc = jfusion.fuse_topk(sid, ss, did, np.where(dm, ds, 0.0), dm,
                                  n_docs, 0.5, k, method=method)
    tids, tsc = tfusion.fuse_topk(_t(sid), _t(ss), _t(did),
                                  _t(np.where(dm, ds, 0.0)), _t(dm), n_docs,
                                  0.5, k, method=method)
    assert (np.asarray(jsc) == 0).sum() > 0       # the case is exercised
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-6)
