"""Baselines the paper compares against (Tables 1, 2, 4, 8), on the
index's device:

  - IVF top-p%: clusters ranked by query-centroid similarity (FAISS IVF
    probe), scored by the cluster_score kernel
  - Rerank: dense-rescore only the sparse top-k ("S + Rerank")
  - CDFS-like: probabilistic cluster thresholding from order statistics
    of the sparse top-k (the contemporary work CluSD is measured
    against; it assumes the rank-score distribution is iid, which is the
    weakness CluSD removes)
  - LADR-like graph navigation: sparse-seeded expansion of a doc-level
    kNN graph (fixed depth/budget); `build_doc_knn` builds the graph on
    the device from the cluster table

Each function is the JAX package's `repro.core.baselines` function for
function; where the order of additions or of a sort decides the result,
the comment says how the port keeps it. Inputs may be numpy arrays or
tensors; they are moved to the index's device.
"""

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

from repro_torch.core import clusd as clusd_lib
from repro_torch.core import fusion as fusion_lib
from repro_torch.core import sparse as sparse_lib
from repro_torch.core.fusion import topk_desc_index_asc
from repro_torch.kernels.cluster_score import cluster_score

# CDFS's geometric rank weight: P(relevant | rank r) ~ RHO ** r
RHO = 0.95
# build_doc_knn: docs scored per pass (the (chunk, N) similarity slab)
KNN_CHUNK = 8192


def _queries(index, q_dense, q_terms, q_weights):
    dev = index.device
    return tuple(torch.as_tensor(x if isinstance(x, torch.Tensor)
                                 else np.array(x), dtype=dt, device=dev)
        for x, dt in ((q_dense, torch.float32), (q_terms, torch.int32),
                      (q_weights, torch.float32)))


# ---------------------------------------------------------------------------
# IVF p% probe
# ---------------------------------------------------------------------------

def ivf_retrieve(cfg, index, q_dense, q_terms, q_weights, n_probe, *,
                 fuse_sparse=True, k=None):
    """Select the top n_probe clusters by query-centroid similarity and
    score every slot of them. Returns (ids, scores, diag)."""
    k = k or cfg.k_final
    q_dense, q_terms, q_weights = _queries(index, q_dense, q_terms, q_weights)
    qc_sim = q_dense @ index.centroids.T
    _, sel_ids = topk_desc_index_asc(qc_sim, n_probe)
    sel_mask = torch.ones_like(sel_ids, dtype=torch.bool)
    did, dscore, dmask = clusd_lib.score_selected(
        index, q_dense, sel_ids.int(), sel_mask)
    if not fuse_sparse:
        s, i = topk_desc_index_asc(torch.where(dmask, dscore, -torch.inf), k)
        return did.gather(1, i), s, {}
    sparse_ids, sparse_scores = sparse_lib.sparse_retrieve_topk(
        index.sparse_index, q_terms, q_weights, cfg.k_sparse)
    ids, scores = fusion_lib.fuse_topk(
        sparse_ids, sparse_scores, did, torch.where(dmask, dscore, 0.0),
        dmask, index.n_docs, cfg.alpha, k)
    return ids, scores, {"n_selected": torch.full(
        (q_dense.shape[0],), n_probe, dtype=torch.int32, device=ids.device)}


# ---------------------------------------------------------------------------
# Rerank (S + Rerank)
# ---------------------------------------------------------------------------

def rerank_retrieve(cfg, index, q_dense, q_terms, q_weights, *, k=None,
                    rerank_depth=None):
    k = k or cfg.k_final
    depth = rerank_depth or cfg.k_sparse
    q_dense, q_terms, q_weights = _queries(index, q_dense, q_terms, q_weights)
    sparse_ids, sparse_scores = sparse_lib.sparse_retrieve_topk(
        index.sparse_index, q_terms, q_weights, depth)
    vecs = index.embeddings[sparse_ids.long()]               # (B, k, dim)
    dscore = torch.einsum("bd,bkd->bk", q_dense, vecs.float())
    # every entry valid, pads included, as in the reference
    mask = torch.ones_like(dscore, dtype=torch.bool)
    ids, scores = fusion_lib.fuse_topk(
        sparse_ids, sparse_scores, sparse_ids, dscore, mask,
        index.n_docs, cfg.alpha, k)
    return ids, scores, {"n_docs_fetched": depth}


# ---------------------------------------------------------------------------
# CDFS-like probabilistic thresholding
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _rank_weights_np(k):
    """RHO ** arange(k) in float32, each power by the C library's powf:
    the reference's `rho ** jnp.arange(k, dtype=float32)` is XLA's CPU
    pow, which is that powf (torch's vectorised pow and float64 pow
    rounded to float32 differ from it in the last bit at a few ranks).
    Subnormal powers (ranks past about 1700) are flushed to zero, as
    XLA's CPU code flushes them."""
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    powf = libm.powf
    powf.restype = ctypes.c_float
    powf.argtypes = [ctypes.c_float, ctypes.c_float]
    w = np.array([powf(RHO, float(r)) for r in range(k)], np.float32)
    w[w < np.finfo(np.float32).tiny] = 0.0
    return w


def rank_weights(k, device):
    """(k,) float32 rank weights RHO ** r, the same bits on every device."""
    return torch.from_numpy(_rank_weights_np(k).copy()).to(device)


def occurrence_ranks(keys):
    """(B, k) int64: for each entry, how many entries before it in its
    row hold the same key (by a stable sort of the row)."""
    B, k = keys.shape
    sk, order = torch.sort(keys, dim=1, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    pos = torch.arange(k, device=keys.device).expand(B, k)
    run_rank = pos - torch.where(first, pos, 0).cummax(1).values
    return torch.empty_like(order).scatter_(1, order, run_rank)


def cdfs_mass(index, sparse_ids):
    """(B, N) float32 cluster mass: the segment sum of the rank weights
    over each sparse doc's cluster. The reference adds a cluster's
    weights in rank order; so does this, one layer per occurrence rank
    (a layer adds at most once to a cluster, so the card's atomic adds
    meet no collision but in the dropped column N)."""
    sparse_ids = sparse_ids.to(index.device)
    B, k = sparse_ids.shape
    N = index.n_clusters
    w = rank_weights(k, sparse_ids.device).expand(B, k)
    c_of = index.doc_cluster[sparse_ids.long()].long()       # (B, k)
    c_of = torch.where(c_of >= 0, c_of, N)    # unclustered: dropped
    rank = occurrence_ranks(c_of)
    mass = torch.zeros((B, N + 1), dtype=torch.float32,
                       device=sparse_ids.device)
    n_layers = int(rank.max()) + 1 if rank.numel() else 0
    for r in range(n_layers):
        at = rank == r
        mass.scatter_add_(1, torch.where(at, c_of, N),
                          torch.where(at, w, 0.0))
    return mass[:, :N]


def cdfs_select(cfg, index, q_dense, sparse_ids, sparse_scores, *,
                p_stop=0.95, max_selected=None):
    """Select clusters by the iid order-statistics model: each sparse
    top-k doc is an iid draw, a cluster's mass the probability-weighted
    count of draws landing in it; clusters are taken in mass order until
    the mass before one reaches p_stop of the total, capped by the static
    budget. Returns (sel_ids (B, S) int32, sel_mask)."""
    S = max_selected or cfg.max_selected
    mass = cdfs_mass(index, sparse_ids)
    top_mass, sel_ids = topk_desc_index_asc(mass, S)
    cum = torch.cumsum(top_mass, dim=1)
    total = torch.sum(mass, dim=1, keepdim=True)
    # keep cluster i if the mass up to and excluding i is under p_stop
    prev = cum - top_mass
    sel_mask = (prev < p_stop * total) & (top_mass > 0)
    return sel_ids.int(), sel_mask


def cdfs_retrieve(cfg, index, q_dense, q_terms, q_weights, *, p_stop=0.95,
                  k=None, max_selected=None):
    k = k or cfg.k_final
    q_dense, q_terms, q_weights = _queries(index, q_dense, q_terms, q_weights)
    sparse_ids, sparse_scores = sparse_lib.sparse_retrieve_topk(
        index.sparse_index, q_terms, q_weights, cfg.k_sparse)
    sel_ids, sel_mask = cdfs_select(cfg, index, q_dense, sparse_ids,
                                    sparse_scores, p_stop=p_stop,
                                    max_selected=max_selected)
    did, dscore, dmask = clusd_lib.score_selected(index, q_dense, sel_ids,
                                                  sel_mask)
    ids, scores = fusion_lib.fuse_topk(
        sparse_ids, sparse_scores, did, torch.where(dmask, dscore, 0.0),
        dmask, index.n_docs, cfg.alpha, k)
    return ids, scores, {"n_selected": sel_mask.sum(1)}


# ---------------------------------------------------------------------------
# LADR-like graph navigation
# ---------------------------------------------------------------------------

def build_doc_knn(index, n_neighbors=16, probe_clusters=4, *,
                  chunk=KNN_CHUNK):
    """Approximate doc-level kNN graph via cluster-restricted search: each
    doc is compared against the docs of its `probe_clusters` nearest
    clusters. Returns (D, n_neighbors) int32 on the index's device — the
    LADR proximity graph.

    The reference loops over docs on the host; this scores `chunk` docs a
    pass, in cluster order (so a pass's docs pick few blocks): the
    centroid similarities and their top-k (near_c), then the cluster_score
    kernel over the index's block table with near_c as the selection —
    each doc's scores against its probe clusters' slots in the
    reference's candidate order (cluster, then slot) — pad slots and the
    doc itself at -inf, and the top n_neighbors. A doc with fewer
    candidates repeats its last pick, or itself when it has none."""
    emb = index.embeddings.float()
    dev = emb.device
    blocks = clusd_lib._device_store(index, index.embeddings).blocks
    cluster_docs = index.cluster_docs
    D, cap = emb.shape[0], cluster_docs.shape[1]
    out = torch.empty((D, n_neighbors), dtype=torch.int32, device=dev)
    order = torch.argsort(index.doc_cluster, stable=True)
    for lo in range(0, D, chunk):
        docs = order[lo:lo + chunk]
        q = emb[docs].contiguous()
        _, near_c = topk_desc_index_asc(q @ index.centroids.T,
                                        probe_clusters)
        near_c = near_c.int().contiguous()
        s = cluster_score(q, blocks, near_c).reshape(len(docs), -1)
        cand = cluster_docs[near_c.long()].reshape(len(docs), -1)
        if cand.shape[1] < n_neighbors:          # fewer slots than picks
            pad = n_neighbors - cand.shape[1]
            s = torch.nn.functional.pad(s, (0, pad))
            cand = torch.nn.functional.pad(cand, (0, pad), value=-1)
        keep = (cand >= 0) & (cand != docs[:, None])
        top_s, top_i = topk_desc_index_asc(
            torch.where(keep, s, -torch.inf), n_neighbors)
        picked = cand.gather(1, top_i)
        valid = torch.isfinite(top_s)
        n_valid = valid.sum(1, keepdim=True)
        last = picked.gather(1, (n_valid - 1).clamp(min=0))
        fill = torch.where(n_valid > 0, last, docs[:, None].int())
        out[docs] = torch.where(valid, picked, fill)
    return out


def _trunc_int32(x):
    """float32 -> int32 values (as int64) toward zero, saturating at the
    int32 range and NaN to 0: XLA's convert, defined for every input."""
    x = torch.nan_to_num(x.double(), nan=0.0)
    return x.clamp(-2 ** 31, 2 ** 31 - 1).trunc().long()


def dedup_keys(ids, scores):
    """The reference's sort key `ids * 1_000_000 - int32(scores)` in
    int32, which wraps for ids >= 2148: computed in int64 and wrapped to
    int32 explicitly, the same values as the reference's int32 overflow."""
    key = ids.long() * 1_000_000 - _trunc_int32(scores)
    return ((key + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _score_docs(emb, q_dense, ids):
    """(B, L) dot scores of the docs `ids` (B, L) with their query."""
    return torch.einsum("bkd,bd->bk", emb[ids.long()].float(), q_dense)


def _expand(emb, doc_knn, pool, pool_s, q_dense, budget):
    """One LADR hop for the whole batch: the pool's graph neighbours
    scored, the pool and neighbours deduplicated by the reference's key
    (stable sort, first of each id's run kept), the best
    min(budget, len) kept under (score desc, position asc)."""
    B, P = pool.shape
    nbrs = doc_knn[pool.long()].reshape(B, -1)              # (B, P*nn)
    s = _score_docs(emb, q_dense, nbrs)
    all_ids = torch.cat([pool, nbrs], 1)
    all_s = torch.cat([pool_s, s], 1)
    order = torch.argsort(dedup_keys(all_ids, all_s), dim=1, stable=True)
    sid = all_ids.gather(1, order)
    ss = all_s.gather(1, order)
    first = torch.ones_like(sid, dtype=torch.bool)
    first[:, 1:] = sid[:, 1:] != sid[:, :-1]
    ss = torch.where(first, ss, -torch.inf)
    top_s, top_i = topk_desc_index_asc(ss, min(budget, ss.shape[1]))
    return sid.gather(1, top_i), top_s


def ladr_retrieve(cfg, index, doc_knn, q_dense, q_terms, q_weights, *,
                  n_seeds=32, depth=2, budget=256, k=None):
    """Seed with the sparse top-n_seeds docs; expand the kNN graph `depth`
    times, keeping a running candidate pool of the `budget` best docs
    (LADR [20]). Batched over queries: the pool sizes are static per
    level (n_seeds, then min(budget, P + P * nn))."""
    k = k or cfg.k_final
    q_dense, q_terms, q_weights = _queries(index, q_dense, q_terms, q_weights)
    doc_knn = doc_knn.to(index.device)
    emb = index.embeddings
    sparse_ids, sparse_scores = sparse_lib.sparse_retrieve_topk(
        index.sparse_index, q_terms, q_weights, cfg.k_sparse)
    pool = sparse_ids[:, :n_seeds]
    pool_s = _score_docs(emb, q_dense, pool)
    for _ in range(depth):
        pool, pool_s = _expand(emb, doc_knn, pool, pool_s, q_dense, budget)
    dmask = torch.isfinite(pool_s)
    ids, scores = fusion_lib.fuse_topk(
        sparse_ids, sparse_scores, pool, torch.where(dmask, pool_s, 0.0),
        dmask, index.n_docs, cfg.alpha, k)
    n_fetched = n_seeds + depth * budget * doc_knn.shape[1]
    return ids, scores, {"n_docs_fetched": n_fetched}
