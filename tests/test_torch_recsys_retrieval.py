"""The port's CluSD candidate retrieval (repro_torch.core.retrieval)
against the JAX package's, on the CPU, on one state: the dlrm and
wide-deep smoke configs, 15000 candidates in 64 clusters of 256 slots.
JAX draws the model parameters, the k-means initialisation and the LSTM
parameters with jax.random and builds the cluster table; the port gets
all of it as numpy.

Tolerances: ids equal at every rank whose score is more than 1e-5 from
both neighbours' (the query-centroid and block dots are summed in
another order), scores rtol 1e-5 and atol 1e-6; n_selected equal where
no LSTM probability lies within 1e-6 of theta; Stage I's P and Q through
bin_overlap bitwise the JAX function's inline segment_sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import isolated_ranks
from repro.configs import get_config as jax_get_config
from repro.core import bins as jbins
from repro.core import fusion as jfusion
from repro.core import kmeans as jkm
from repro.core import retrieval as jret
from repro.core.lstm import lstm_apply, lstm_init
from repro.models import recsys as jrs
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.convert import recsys_params_from_numpy, selector_from_numpy
from repro_torch.core import retrieval as ret
from repro_torch.core.bins import rank_bin_ids
from repro_torch.data import RecsysStream
from repro_torch.kernels.bin_overlap import bin_overlap
from repro_torch.models import recsys as rs

N_CAND, N, CAP, N_QUERIES = 15000, 64, 256, 4


@pytest.fixture(scope="module", params=["dlrm-mlperf", "wide-deep"])
def state(request):
    arch = request.param
    jcfg, tcfg = jax_get_config(arch, "smoke"), get_config(arch, "smoke")
    jp = jrs.init_params(jcfg, jax.random.key(1))
    rng = np.random.default_rng(0)
    raw = np.stack([rng.integers(0, jcfg.table_sizes[i], N_CAND)
                    for i in range(2)], 1).astype(np.int32)
    vecs = np.asarray(jrs.candidate_tower(jcfg, jp, jnp.asarray(raw)))
    cents, assign = jkm.kmeans(jax.random.key(2), jnp.asarray(vecs), N,
                               iters=8)
    table, _ = jkm.build_cluster_table(assign, N, CAP, vecs, cents)
    table = np.asarray(table)
    valid = table >= 0
    blocks = np.zeros((N, CAP, vecs.shape[1]), np.float32)
    blocks[valid] = vecs[table[valid]]
    cand = np.zeros((N * CAP, 2), np.int32)
    cand[valid.reshape(-1)] = raw[table[valid]]
    nb_ids, nb_sims = jkm.neighbor_graph(cents, N - 1)
    spec = ret.CandidateIndexSpec(n_candidates=N_CAND, n_clusters=N,
                                  cap=CAP, k_guide=1024, max_selected=12,
                                  theta=0.4705, alpha=0.3, k_final=100)
    lstm = lstm_init(jax.random.key(3), 1 + spec.u_bins + 2 * spec.v_bins,
                     32)
    users = {k: v for k, v in RecsysStream(tcfg, seed=3).batch(N_QUERIES)
             .items() if k != "label"}
    arrays = {"blocks": blocks, "cand": cand, "valid": valid.reshape(-1),
              "cents": np.asarray(cents), "nb_ids": np.asarray(nb_ids),
              "nb_sims": np.asarray(nb_sims)}
    jax_in = {k: jnp.asarray(v) for k, v in arrays.items()}
    t_in = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
    model = rs.RecsysModel(tcfg, recsys_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), device="cpu"), device="cpu")
    sel = selector_from_numpy({k: np.asarray(v) for k, v in lstm.items()},
                              device="cpu")
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jp=jp, spec=spec,
                lstm=lstm, users=users, jax_in=jax_in, t_in=t_in,
                model=model, sel=sel)


def _user(users, q, lib):
    if lib == "jax":
        return {k: jnp.asarray(v[q:q + 1]) for k, v in users.items()}
    return rs.as_batch({k: v[q:q + 1] for k, v in users.items()}, "cpu")


def _jax_retrieve(s, q):
    j = s["jax_in"]
    fn = jax.jit(lambda p, b, l: jret.clusd_candidate_retrieval(
        s["jcfg"], s["spec"], p, b, j["cand"], j["blocks"], j["cents"], l,
        j["nb_ids"], j["nb_sims"], slot_valid=j["valid"]))
    return fn(s["jp"], _user(s["users"], q, "jax"), s["lstm"])


def _torch_retrieve(s, q):
    t = s["t_in"]
    with torch.no_grad():
        return ret.clusd_candidate_retrieval(
            s["tcfg"], s["spec"], s["model"], _user(s["users"], q, "torch"),
            t["cand"], t["blocks"], t["cents"], s["sel"], t["nb_ids"],
            t["nb_sims"], slot_valid=t["valid"])


def _assert_same(t_ids, t_sc, j_ids, j_sc, what):
    j_sc = np.asarray(j_sc)[None]
    ok = isolated_ranks(j_sc)
    assert ok.sum() > 50, what
    np.testing.assert_array_equal(t_ids.numpy()[None][ok],
                                  np.asarray(j_ids)[None][ok], err_msg=what)
    np.testing.assert_allclose(t_sc.numpy()[None], j_sc, rtol=1e-5,
                               atol=1e-6, err_msg=what)


def test_clusd_candidate_retrieval_matches_jax(state):
    before = dict(kernels.LAUNCHES)
    n_sel = []
    for q in range(N_QUERIES):
        j_ids, j_sc, j_diag = _jax_retrieve(state, q)
        t_ids, t_sc, t_diag = _torch_retrieve(state, q)
        assert t_ids.dtype == torch.int32 and t_ids.shape == (100,)
        _assert_same(t_ids, t_sc, j_ids, j_sc, f"{state['arch']} q{q}")
        n_sel.append(int(t_diag["n_selected"]))
        assert 0 < n_sel[-1] <= state["spec"].max_selected
        if not _near_theta(state, q):
            assert n_sel[-1] == int(j_diag["n_selected"]), q
    assert kernels.LAUNCHES == before         # the CPU path launches nothing
    # the untrained LSTM's probabilities lie near 0.47: theta leaves out
    # some of the 32 Stage-I candidates, and the budget of 12 others
    assert min(n_sel) < state["spec"].max_selected, n_sel


def _near_theta(state, q):
    """Whether the JAX LSTM puts a Stage-I candidate within 1e-6 of theta
    (recomputed from the JAX function's own stage functions)."""
    spec, j = state["spec"], state["jax_in"]
    ju = jrs.user_tower(state["jcfg"], state["jp"],
                        _user(state["users"], q, "jax"))
    g = jret.guide_scores(state["jcfg"], state["jp"], ju,
                          j["blocks"].reshape(N * CAP, -1), j["cand"])
    g = jnp.where(j["valid"], g, -jnp.inf)
    gs, gi = jax.lax.top_k(g, spec.k_guide)
    P, Q = _jax_inline_pq(gi, gs, spec)
    qc = (j["cents"] @ ju[0])[None]
    from repro.core import features as jfeat
    from repro.core import stage1 as jst
    cand = jst.sort_by_overlap(P, qc, spec.n_candidates_stage1)
    feats = jfeat.candidate_features(cand, qc, P, Q, j["nb_ids"],
                                     j["nb_sims"], spec.u_bins)
    probs = np.asarray(lstm_apply(state["lstm"], feats))
    return bool((np.abs(probs - spec.theta) < 1e-6).any())


def _jax_inline_pq(g_ids, g_scores, spec):
    """Stage I's P and Q as repro.core.retrieval computes them inline."""
    bin_ids = jbins.rank_bin_ids(spec.bins, spec.k_guide)
    slot = (g_ids // CAP) * spec.v_bins + bin_ids
    gn = jfusion.minmax_norm(g_scores[None])[0]
    cnt = jax.ops.segment_sum(jnp.ones_like(gn), slot,
                              num_segments=N * spec.v_bins)
    ssum = jax.ops.segment_sum(gn, slot, num_segments=N * spec.v_bins)
    P = cnt.reshape(N, spec.v_bins)[None]
    Q = (ssum / jnp.maximum(cnt, 1.0)).reshape(N, spec.v_bins)[None]
    return P, Q


def test_brute_force_retrieval_matches_jax(state):
    j = state["jax_in"]
    for q in range(N_QUERIES):
        j_ids, j_sc = jret.brute_force_retrieval(
            state["jcfg"], state["jp"], _user(state["users"], q, "jax"),
            j["blocks"], k=100)
        t_ids, t_sc = ret.brute_force_retrieval(
            state["tcfg"], state["model"], _user(state["users"], q, "torch"),
            state["t_in"]["blocks"], k=100)
        assert t_ids.dtype == torch.int32
        _assert_same(t_ids, t_sc, j_ids, j_sc, f"{state['arch']} q{q}")


def test_stage1_pq_through_bin_overlap_bitwise_vs_segment_sum(state):
    """The guide top-k of a wide or prefix-dot guide, with heavy runs of
    equal clusters, through the port's bin_overlap and through the JAX
    function's inline segment_sums."""
    spec = state["spec"]
    rng = np.random.default_rng(5)
    g_ids = np.sort(rng.choice(N * CAP, spec.k_guide, replace=False))
    rng.shuffle(g_ids)
    g_scores = -np.sort(-rng.standard_normal(spec.k_guide)).astype(
        np.float32)
    P, Q = _jax_inline_pq(jnp.asarray(g_ids, jnp.int32),
                          jnp.asarray(g_scores), spec)
    gn = torch.from_numpy(np.array(
        jfusion.minmax_norm(jnp.asarray(g_scores)[None])))
    tP, tQ = bin_overlap(torch.from_numpy(g_ids // CAP)[None].int(),
                         rank_bin_ids(spec.bins, spec.k_guide, device="cpu"),
                         gn, n_clusters=N, v=spec.v_bins)
    assert (np.asarray(P) > 1).any()
    assert np.array_equal(tP.numpy(), np.asarray(P))
    assert np.array_equal(tQ.numpy().view(np.int32),
                          np.asarray(Q).view(np.int32))


def test_shard_local_guide_topk_is_not_ported(state):
    """The shard-local guide top-k runs only under a torch.distributed
    process group (tests/test_torch_distributed.py holds it to the global
    top-k there); without one it raises and never falls back to the
    global top-k."""
    spec = dataclasses.replace(state["spec"], local_topk=True)
    t = state["t_in"]
    with pytest.raises(RuntimeError, match="process group"):
        ret.clusd_candidate_retrieval(
            state["tcfg"], spec, state["model"], _user(state["users"], 0,
                                                       "torch"),
            t["cand"], t["blocks"], t["cents"], state["sel"], t["nb_ids"],
            t["nb_sims"], slot_valid=t["valid"])
