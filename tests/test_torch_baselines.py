"""The port's baselines (repro_torch.core.baselines) against the JAX
package's (repro.core.baselines) on one JAX smoke index (4096 docs, 64
clusters) carried across by `convert.index_from_numpy`, on the same numpy
queries.

Tolerances: ids equal at the ranks whose score is isolated (more than
1e-5 from both neighbours), scores within rtol 1e-5, atol 1e-6 (dot
products summed in another order), -inf at the same places. The CDFS
rank weights and mass are bitwise; the CDFS selection is compared away
from the band |prev - p_stop * total| < 1e-6 * total, where the two
cumsums may round apart. The kNN graph is compared away from ties: the
doc's probe clusters and each neighbour's score isolated by 1e-5.
"""

import numpy as np
import pytest
import torch

from _torch_parity import (index_arrays, isolated_ranks, jax_smoke_state,
                           torch_cfg)

N_QUERIES = 16


@pytest.fixture(scope="module")
def state():
    import jax.numpy as jnp

    from repro.core import baselines as jb
    from repro.data import synth_queries
    from repro_torch.convert import index_from_numpy

    cfg, index, corpus = jax_smoke_state(0)
    arrays = index_arrays(index)
    arrays["embeddings"] = np.asarray(corpus.embeddings)
    index.embeddings = jnp.asarray(corpus.embeddings)
    qs = synth_queries(5, corpus, N_QUERIES)
    knn = np.asarray(jb.build_doc_knn(index, n_neighbors=8,
                                      probe_clusters=3))
    return {"cfg": cfg, "index": index, "tcfg": torch_cfg(cfg),
            "tindex": index_from_numpy(arrays, device="cpu"),
            "q3": (qs.q_dense, qs.q_terms, qs.q_weights),
            "emb": arrays["embeddings"], "knn": knn}


def assert_same(t, j):
    tids, tsc = (x.numpy() for x in t[:2])
    jids, jsc = (np.asarray(x) for x in j[:2])
    assert tids.shape == jids.shape and tsc.shape == jsc.shape
    fin = np.isfinite(jsc)
    assert (np.isfinite(tsc) == fin).all()
    np.testing.assert_allclose(tsc[fin], jsc[fin], rtol=1e-5, atol=1e-6)
    with np.errstate(invalid="ignore"):
        ok = isolated_ranks(np.where(fin, jsc, -1e30)) & fin
    assert ok.sum() > 0.5 * fin.sum()
    assert (tids[ok] == jids[ok]).all()


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("n_probe", [1, 6])
def test_ivf_retrieve_matches_jax(state, fuse, n_probe):
    from repro.core import baselines as jb
    from repro_torch.core import baselines as tb

    j = jb.ivf_retrieve(state["cfg"], state["index"], *state["q3"], n_probe,
                        fuse_sparse=fuse)
    t = tb.ivf_retrieve(state["tcfg"], state["tindex"], *state["q3"],
                        n_probe, fuse_sparse=fuse)
    assert_same(t, j)
    if fuse:
        assert (t[2]["n_selected"].numpy()
                == np.asarray(j[2]["n_selected"])).all()


def test_rerank_retrieve_matches_jax(state):
    from repro.core import baselines as jb
    from repro_torch.core import baselines as tb

    for depth in (None, 40):
        j = jb.rerank_retrieve(state["cfg"], state["index"], *state["q3"],
                               rerank_depth=depth)
        t = tb.rerank_retrieve(state["tcfg"], state["tindex"], *state["q3"],
                               rerank_depth=depth)
        assert_same(t, j)
        assert t[2] == j[2]


def test_cdfs_rank_weights_are_bitwise_jax(state):
    import jax.numpy as jnp

    from repro_torch.core import baselines as tb

    for k in (state["cfg"].k_sparse, 1000, 2048):
        want = np.asarray(tb.RHO ** jnp.arange(k, dtype=jnp.float32))
        got = tb.rank_weights(k, "cpu").numpy()
        assert got.dtype == np.float32
        assert (got.view(np.int32) == want.view(np.int32)).all()


def _jax_mass(index, sparse_ids):
    """The reference's mass, as cdfs_select computes it."""
    import jax
    import jax.numpy as jnp

    k = sparse_ids.shape[1]
    w = 0.95 ** jnp.arange(k, dtype=jnp.float32)
    c_of = jnp.take(index.doc_cluster, sparse_ids, axis=0)
    return np.asarray(jax.vmap(lambda c: jax.ops.segment_sum(
        w, c, num_segments=index.n_clusters))(c_of))


def test_cdfs_mass_bitwise_and_selection_away_from_the_band(state):
    import jax.numpy as jnp

    from repro.core import baselines as jb
    from repro.core import sparse as jsparse
    from repro_torch.core import baselines as tb

    cfg, index = state["cfg"], state["index"]
    _, qt, qw = state["q3"]
    sid, ss = jsparse.sparse_retrieve_topk(index.sparse_index,
                                           jnp.asarray(qt), jnp.asarray(qw),
                                           cfg.k_sparse)
    t_sid = torch.from_numpy(np.array(sid))
    mass = tb.cdfs_mass(state["tindex"], t_sid).numpy()
    want = _jax_mass(index, sid)
    assert (mass.view(np.int32) == want.view(np.int32)).all()
    # clusters holding several of a query's docs: the order of adds counts
    assert (tb.occurrence_ranks(
        state["tindex"].doc_cluster[t_sid.long()]) > 2).any()
    for p_stop in (0.5, 0.95):
        j_ids, j_mask = (np.asarray(x) for x in jb.cdfs_select(
            cfg, index, None, sid, ss, p_stop=p_stop))
        t_ids, t_mask = (x.numpy() for x in tb.cdfs_select(
            state["tcfg"], state["tindex"], None, t_sid,
            torch.from_numpy(np.array(ss)), p_stop=p_stop))
        assert (t_ids == j_ids).all()
        top = np.take_along_axis(want, j_ids, 1).astype(np.float64)
        prev = np.cumsum(top, 1) - top
        total = want.astype(np.float64).sum(1, keepdims=True)
        away = np.abs(prev - p_stop * total) >= 1e-6 * total
        assert away.mean() > 0.9
        assert (t_mask[away] == j_mask[away]).all()


def test_cdfs_retrieve_matches_jax(state):
    from repro.core import baselines as jb
    from repro_torch.core import baselines as tb

    j = jb.cdfs_retrieve(state["cfg"], state["index"], *state["q3"])
    t = tb.cdfs_retrieve(state["tcfg"], state["tindex"], *state["q3"])
    assert_same(t, j)
    n_sel = t[2]["n_selected"].numpy()
    assert (n_sel == np.asarray(j[2]["n_selected"])).all()
    assert 0 < n_sel.min() and n_sel.max() <= state["cfg"].max_selected


def _knn_comparable(emb, centroids, knn, pc, tol=1e-5):
    """(D,) rows whose probe clusters are isolated from the next cluster,
    and (D, nn) neighbour ranks whose score is isolated."""
    e = emb.astype(np.float64)
    sims = np.sort(e @ centroids.astype(np.float64).T, 1)[:, ::-1]
    rows = np.abs(sims[:, pc - 1] - sims[:, pc]) > tol
    s = np.einsum("dnk,dk->dn", e[knn], e)
    with np.errstate(invalid="ignore"):
        ranks = isolated_ranks(s, tol)
    return rows, ranks


def test_build_doc_knn_matches_jax(state):
    from repro_torch.core import baselines as tb

    want = state["knn"]
    got = tb.build_doc_knn(state["tindex"], n_neighbors=8, probe_clusters=3,
                           chunk=1000)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    got = got.numpy()
    rows, ranks = _knn_comparable(state["emb"],
                                  state["tindex"].centroids.numpy(), want, 3)
    assert rows.mean() > 0.95 and ranks[rows].mean() > 0.8
    ok = rows[:, None] & ranks
    assert (got[ok] == want[ok]).all()
    assert (got != np.arange(len(got))[:, None]).all()


def test_build_doc_knn_pads_as_jax():
    """Docs with fewer candidates than neighbours repeat their last pick,
    or themselves with none (a cluster of one doc)."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from repro.core import baselines as jb
    from repro_torch.convert import index_from_numpy
    from repro_torch.core import baselines as tb

    rng = np.random.default_rng(3)
    emb = rng.standard_normal((10, 8)).astype(np.float32)
    cluster_docs = np.array([[0, 1, 2, -1], [3, 4, -1, -1], [5, -1, -1, -1],
                             [6, 7, 8, 9]], np.int32)
    doc_cluster = np.zeros(10, np.int32)
    for c, row in enumerate(cluster_docs):
        doc_cluster[row[row >= 0]] = c
    centroids = np.stack([emb[r[r >= 0]].mean(0) for r in cluster_docs])
    want = np.asarray(jb.build_doc_knn(SimpleNamespace(
        embeddings=jnp.asarray(emb), centroids=jnp.asarray(centroids),
        cluster_docs=jnp.asarray(cluster_docs)), n_neighbors=5,
        probe_clusters=1))
    arrays = {"centroids": centroids, "cluster_docs": cluster_docs,
              "doc_cluster": doc_cluster,
              "neighbor_ids": np.zeros((4, 1), np.int32),
              "neighbor_sims": np.zeros((4, 1), np.float32),
              "bin_ids": np.zeros(4, np.int32),
              "sparse_postings_docs": np.full((2, 2), -1, np.int32),
              "sparse_postings_weights": np.zeros((2, 2), np.float32),
              "embeddings": emb}
    got = tb.build_doc_knn(index_from_numpy(arrays, device="cpu"),
                           n_neighbors=5, probe_clusters=1, chunk=3)
    assert (got.numpy() == want).all()


def test_ladr_dedup_key_wraps_as_jax_int32():
    import jax.numpy as jnp

    from repro_torch.core import baselines as tb

    ids = np.array([0, 7, 2147, 2148, 4095, 1 << 19, (1 << 20) - 1] * 3,
                   np.int32)
    s = np.repeat(np.array([0.7, -3.9, 2.5e9], np.float32), 7)
    s[3], s[10] = -np.inf, np.nan
    want = np.asarray(jnp.asarray(ids) * 1_000_000
                      - jnp.asarray(s).astype(jnp.int32))
    got = tb.dedup_keys(torch.from_numpy(ids), torch.from_numpy(s)).numpy()
    assert got.dtype == np.int32 and (got == want).all()
    assert got[4] == -199967296


@pytest.mark.parametrize("kw", [dict(n_seeds=64, depth=3, budget=512),
                                dict(n_seeds=16, depth=2, budget=256)],
                         ids=["default", "fast"])
def test_ladr_retrieve_matches_jax(state, kw):
    import jax.numpy as jnp

    from repro.core import baselines as jb
    from repro_torch.core import baselines as tb

    j = jb.ladr_retrieve(state["cfg"], state["index"],
                         jnp.asarray(state["knn"]), *state["q3"], **kw)
    t = tb.ladr_retrieve(state["tcfg"], state["tindex"],
                         torch.from_numpy(state["knn"].copy()),
                         *state["q3"], **kw)
    assert_same(t, j)
    assert t[2] == j[2]
    # the wrap is live: pools hold ids whose key wraps
    assert int(t[0].max()) >= 2148
