"""Stage parity of repro_torch.core against the JAX package on the CPU,
on a smoke-width index that the JAX package builds and repro_torch.convert
carries across: sparse retrieval, the neighbor graph, overlap features,
Stage-I candidates, candidate features and Stage-II selection.

Tolerances, each with its reason:
  * sparse top-k ids, P counts: exact — the same sums of at most Tq
    addends, and integer counts.
  * sparse scores 1e-6; Q, features, neighbor sims 1e-6 to 1e-5 —
    segment sums, means and matmuls in another order.
  * Stage-II probs: 1e-5 — two LSTMs (scan vs loop) over 16 steps.
  * Stage-I candidates and selections: exact away from near-ties of the
    float keys they sort.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_tensor as _t
from _torch_parity import index_arrays, jax_smoke_state, torch_cfg
from repro.core import bins as jbins
from repro.core import clusd as jcl
from repro.core import fusion as jfusion
from repro.core import kmeans as jkm
from repro.core import sparse as jsparse
from repro.data import synth_queries as jax_synth_queries
from repro_torch import convert
from repro_torch.core import bins as tbins
from repro_torch.core import clusd as tcl
from repro_torch.core import features as tfeat
from repro_torch.core import kmeans as tkm
from repro_torch.core import sparse as tsparse



@pytest.fixture(scope="module")
def state():
    cfg, index, corpus = jax_smoke_state(0)
    t_index = convert.index_from_numpy(index_arrays(index), device="cpu")
    qs = jax_synth_queries(3, corpus, 24)
    sid, ss = jsparse.sparse_retrieve_topk(index.sparse_index, qs.q_terms,
                                           qs.q_weights, cfg.k_sparse)
    return cfg, index, corpus, t_index, qs, sid, ss


def test_sparse_retrieve_matches_jax(state):
    cfg, index, _, t_index, qs, sid, ss = state
    ids, scores = tsparse.sparse_retrieve_topk(
        t_index.sparse_index, _t(qs.q_terms), _t(qs.q_weights), cfg.k_sparse)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ss), rtol=1e-6)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(sid))


def test_neighbor_graph_matches_jax(state):
    _, index, _, _, _, _, _ = state
    C = np.asarray(index.centroids)
    ji, js = jkm.neighbor_graph(jnp.asarray(C), 16)
    ti, ts = tkm.neighbor_graph(_t(C), 16)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)


def test_overlap_features_P_exact_Q_close(state):
    cfg, index, _, t_index, _, sid, ss = state
    norm = jfusion.minmax_norm(ss)
    jP, jQ = jbins.overlap_features(sid, norm, index.doc_cluster,
                                    index.n_clusters, index.bin_ids,
                                    cfg.v_bins)
    tP, tQ = tbins.overlap_features(_t(sid), _t(norm), t_index.doc_cluster,
                                    t_index.n_clusters, t_index.bin_ids,
                                    cfg.v_bins)
    np.testing.assert_array_equal(tP.numpy(), np.asarray(jP))
    np.testing.assert_allclose(tQ.numpy(), np.asarray(jQ), rtol=1e-6,
                               atol=1e-6)


def _stage1_pair(state, expand_depth, stage1="overlap"):
    cfg, index, _, t_index, qs, sid, ss = state
    cfg = dataclasses.replace(cfg, expand_depth=expand_depth)
    j = jcl.stage1_candidates(cfg, index, qs.q_dense, sid, ss, stage1=stage1)
    t = tcl.stage1_candidates(torch_cfg(cfg), t_index, _t(qs.q_dense),
                              _t(sid), _t(ss), stage1=stage1)
    return cfg, j, t


@pytest.mark.parametrize("expand_depth,stage1", [(0, "overlap"),
                                                 (2, "overlap"),
                                                 (0, "dist")])
def test_stage1_candidates_equal_away_from_near_ties(state, expand_depth,
                                                     stage1):
    cfg, j, t = _stage1_pair(state, expand_depth, stage1)
    jc, tc = np.asarray(j["cand"]), t["cand"].numpy()
    assert tc.shape == jc.shape == (24, cfg.n_candidates_total)
    sim = np.sort(np.asarray(j["qc_sim"]), axis=1)
    clean = np.diff(sim, axis=1).min(axis=1) > 1e-5   # no qc_sim near-tie
    assert clean.sum() >= 20
    np.testing.assert_array_equal(tc[clean], jc[clean])


def test_candidate_features_close(state):
    cfg, j, t = _stage1_pair(state, 0)
    index, t_index = state[1], state[3]
    cand = np.asarray(j["cand"])
    tf = tfeat.candidate_features(
        _t(cand), _t(j["qc_sim"]), _t(j["P"]), _t(j["Q"]),
        t_index.neighbor_ids, t_index.neighbor_sims, cfg.u_bins)
    assert tf.shape[-1] == tfeat.feature_dim(cfg) == 1 + 4 + 2 * 4
    np.testing.assert_allclose(tf.numpy(), np.asarray(j["feats"]),
                               rtol=1e-6, atol=1e-6)


def test_stage2_probs_and_selection(state):
    cfg, j, _ = _stage1_pair(state, 0)
    index, t_index = state[1], state[3]
    cand, feats = np.asarray(j["cand"]), np.asarray(j["feats"])
    probs0 = np.asarray(jcl.stage2_select(cfg, index, cand, feats)["probs"])
    # a theta inside the probs' range so that the threshold decides
    cfg = dataclasses.replace(cfg, theta=float(np.median(probs0)))
    js = jcl.stage2_select(cfg, index, cand, feats)
    with torch.no_grad():
        ts = tcl.stage2_select(torch_cfg(cfg), t_index, _t(cand), _t(feats))
    jp, tp = np.asarray(js["probs"]), ts["probs"].numpy()
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
    far = np.abs(jp - cfg.theta) > 1e-4
    np.testing.assert_array_equal((tp >= cfg.theta)[far],
                                  (jp >= cfg.theta)[far])
    srt = np.sort(jp, axis=1)
    clean = far.all(1) & (np.diff(srt, axis=1).min(1) > 1e-5)
    assert clean.sum() >= 12
    np.testing.assert_array_equal(ts["sel_ids"].numpy()[clean],
                                  np.asarray(js["sel_ids"])[clean])
    np.testing.assert_array_equal(ts["sel_mask"].numpy()[clean],
                                  np.asarray(js["sel_mask"])[clean])


def test_sparse_scores_of_docs_reached_by_many_terms_are_bitwise_jax():
    """Every doc is reached by 4 query terms and twice by one of them (it
    holds term 0 twice, so term 0's list holds it twice), and the query
    repeats a term: the port adds a doc's contributions in the JAX
    segment_sum's index order, so its scores are the JAX scores bit for
    bit, where summing them in another order gives other bits."""
    rng = np.random.default_rng(11)
    D, vocab = 300, 6
    doc_terms = np.tile(np.array([0, 1, 2, 3, 0, 5], np.int32), (D, 1))
    doc_weights = rng.lognormal(0.0, 1.0, (D, 6)).astype(np.float32)
    q_terms = np.array([[0, 1, 2, 3, 3, 4], [3, 2, 1, 0, -1, 0]], np.int32)
    q_weights = rng.lognormal(0.0, 1.0, (2, 6)).astype(np.float32)
    j_index = jsparse.SparseIndex.build(doc_terms, doc_weights, vocab, 2 * D)
    t_index = tsparse.SparseIndex.build(doc_terms, doc_weights, vocab, 2 * D,
                                        device="cpu")
    assert t_index.occurrence_ranks()[1] == 2
    _, _, want = jsparse.sparse_retrieve(j_index, q_terms, q_weights, 10)
    _, _, got = tsparse.sparse_retrieve(t_index, _t(q_terms), _t(q_weights),
                                        10)
    want = np.asarray(want)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # the same addends in reverse order differ in the last bits somewhere
    pd, pw = (np.asarray(a) for a in (j_index.postings_docs,
                                      j_index.postings_weights))
    rev = np.zeros((2, D + 1), np.float32)
    for b in range(2):
        for t in reversed(range(q_terms.shape[1])):
            if q_terms[b, t] < 0:
                continue
            for p in reversed(range(pd.shape[1])):
                d = pd[q_terms[b, t], p]
                if d >= 0:
                    rev[b, d] += np.float32(pw[q_terms[b, t], p]
                                            * q_weights[b, t])
    assert not np.array_equal(rev[:, :D], want)
    np.testing.assert_allclose(rev[:, :D], want, rtol=1e-6)
