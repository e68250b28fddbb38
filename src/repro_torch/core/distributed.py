"""Distributed CluSD serving over torch.distributed (a port of
repro.core.distributed).

Layout: docs are renumbered into cluster-blocked order, doc id = c*cap +
s, so cluster membership is `id // cap` (no cluster_docs table), and the
embedding store is an (N, cap, dim) block array split over the 'model'
ranks by contiguous cluster ranges. Queries split over the 'data' ranks.

Serve step (one call per rank, `make_serve_step`):
  1. sparse scoring against the rank's own posting shard -> local scores
     over its cap * N_local docs -> local top-k -> all-gather over the
     model group -> merged global sparse top-k     [term-at-doc-owner]
  2. Stage I/II replicated on every model rank (kernels bin_overlap,
     topk, lstm_sequence)
  3. each rank scores the selected clusters it owns (kernel
     cluster_score, reading its blocks in place) -> local top-k ->
     all-gather merge
  4. sort-merge fusion (fuse_topk_merge; no O(n_docs) buffer)

A ServeMesh stands for the JAX package's ('data', 'model') device mesh:
the rank's two coordinates and its model-axis process group. The
gathers run in rank order over that group; a gloo group on CUDA tensors
stages them through host memory (NCCL refuses two ranks on one card).
"""

import dataclasses

import numpy as np
import torch

from repro_torch.core import bins as bins_lib
from repro_torch.core import features as feat_lib
from repro_torch.core import fusion as fusion_lib
from repro_torch.core import stage1 as stage1_lib
from repro_torch.core.fusion import topk_desc_index_asc
from repro_torch.device import resolve_device
from repro_torch.kernels.bin_overlap import ops as bin_overlap_ops
from repro_torch.kernels.cluster_score import cluster_score
from repro_torch.kernels.topk.ops import MAX_K
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.mesh import make_mesh as make_named_mesh
from repro_torch.models import collectives as coll


@dataclasses.dataclass
class BlockedIndex:
    """Host-built CluSD index in blocked-doc layout (numpy)."""
    blocks: np.ndarray          # (N, cap, dim)
    valid: np.ndarray           # (N, cap) bool
    centroids: np.ndarray       # (N, dim)
    neighbor_ids: np.ndarray    # (N, m)
    neighbor_sims: np.ndarray   # (N, m)
    postings_docs: np.ndarray   # (V, P) blocked doc ids, -1 pad
    postings_weights: np.ndarray  # (V, P)
    old_to_new: np.ndarray      # (D,) original doc id -> blocked id
    selector: object = None     # the index's Stage-II module

    @property
    def n_clusters(self):
        return self.valid.shape[0]

    @property
    def cap(self):
        return self.valid.shape[1]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def blocked_ids(cluster_docs, n_docs):
    """(valid (N, cap) bool, old_to_new (n_docs,) int64): the blocked id
    c*cap + s of each doc in cluster_docs, -1 for a doc in no slot."""
    cd = _np(cluster_docs)
    cap = cd.shape[1]
    valid = cd >= 0
    old_to_new = np.full(n_docs, -1, np.int64)
    c_idx, s_idx = np.nonzero(valid)
    old_to_new[cd[valid]] = c_idx * cap + s_idx
    return valid, old_to_new


def blocked_blocks(embeddings, cluster_docs, lo=0, hi=None):
    """(hi - lo, cap, dim) float32 blocks of clusters [lo, hi): each slot
    its doc's embedding, pad slots zero. `embeddings` may be an
    np.memmap: only the rows of those clusters are read."""
    cd = _np(cluster_docs)[lo:hi]
    valid = cd >= 0
    blocks = np.zeros(cd.shape + (embeddings.shape[1],), np.float32)
    blocks[valid] = embeddings[np.sort(cd[valid])][
        np.argsort(np.argsort(cd[valid]))]
    return blocks


def renumber_postings(postings_docs, old_to_new):
    """Posting doc ids in blocked numbering, -1 pads kept (int32)."""
    pd = _np(postings_docs)
    return np.where(pd >= 0, old_to_new[np.maximum(pd, 0)],
                    -1).astype(np.int32)


def build_blocked_index(cfg, index, embeddings=None):
    """A repro_torch CluSDIndex (tensors on any device) in blocked layout,
    on the host. `embeddings` (D, dim), or the index's own."""
    emb = embeddings if embeddings is not None else _np(index.embeddings)
    valid, old_to_new = blocked_ids(index.cluster_docs, emb.shape[0])
    sp = index.sparse_index
    return BlockedIndex(
        blocks=blocked_blocks(emb, index.cluster_docs), valid=valid,
        centroids=_np(index.centroids),
        neighbor_ids=_np(index.neighbor_ids),
        neighbor_sims=_np(index.neighbor_sims),
        postings_docs=renumber_postings(sp.postings_docs, old_to_new),
        postings_weights=_np(sp.postings_weights), old_to_new=old_to_new,
        selector=index.selector)


def shard_ranges(n_clusters, n_shards):
    """Balanced contiguous cluster partition: shard s owns [lo_s, hi_s)
    with sizes differing by at most 1 (the first `n_clusters % n_shards`
    shards get the extra cluster). Returns a list of (lo, hi) tuples
    covering [0, n_clusters) with no gaps."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_clusters < n_shards:
        raise ValueError(f"cannot split {n_clusters} clusters over "
                         f"{n_shards} shards (need >= 1 each)")
    bounds = [(s * n_clusters) // n_shards for s in range(n_shards + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def owner_of(cluster_ids, ranges):
    """Shard index owning each cluster id, per `ranges` (contiguous
    ascending (lo, hi) as from shard_ranges); ids outside every range
    raise (ownership must be total)."""
    his = np.asarray([hi for _, hi in ranges], np.int64)
    los = np.asarray([lo for lo, _ in ranges], np.int64)
    ids = np.asarray(cluster_ids, np.int64)
    s = np.searchsorted(his, ids, side="right")
    if np.any((ids < 0) | (s >= len(his))) or np.any(ids < los[np.minimum(
            s, len(his) - 1)]):
        raise ValueError("cluster id outside every shard range")
    return s


def postings_by_owner(postings_docs, postings_weights, n_clusters, cap,
                      n_shards):
    """(V, n_shards, P_shard) ids and weights: each term's postings of
    the docs whose cluster shard s owns, in their original order, padded
    (-1, 0.0) to P_shard, a multiple of 8 (at least 8)."""
    pd = _np(postings_docs)
    pw = _np(postings_weights)
    V, P = pd.shape
    his = np.asarray([hi for _, hi in shard_ranges(n_clusters, n_shards)],
                     np.int64)
    # pads get owner n_shards and sort after every shard's postings
    owner = np.where(pd >= 0, np.searchsorted(his, pd // cap, side="right"),
                     n_shards)
    counts = np.stack([(owner == s).sum(axis=1) for s in range(n_shards)], 1)
    p_shard = max(8, -(-int(counts.max(initial=0)) // 8) * 8)
    order = np.argsort(owner, axis=1, kind="stable")
    own_s = np.take_along_axis(owner, order, axis=1)
    starts = np.concatenate([np.zeros((V, 1), np.int64),
                             np.cumsum(counts, axis=1)], axis=1)
    rank = np.arange(P)[None, :] - np.take_along_axis(
        starts, np.minimum(own_s, n_shards), axis=1)
    real = own_s < n_shards
    t = np.broadcast_to(np.arange(V)[:, None], (V, P))[real]
    docs = np.full((V, n_shards, p_shard), -1, np.int32)
    ws = np.zeros((V, n_shards, p_shard), np.float32)
    docs[t, own_s[real], rank[real]] = np.take_along_axis(pd, order, 1)[real]
    ws[t, own_s[real], rank[real]] = np.take_along_axis(pw, order, 1)[real]
    return docs, ws


def shard_postings_by_owner(bidx: BlockedIndex, n_shards):
    """Repartition each term's posting list by doc owner shard so sparse
    scoring is local: returns (V, n_shards, P_shard) ids + weights, the
    balanced contiguous split of `shard_ranges` (total for any N)."""
    return postings_by_owner(bidx.postings_docs, bidx.postings_weights,
                             bidx.n_clusters, bidx.cap, n_shards)


# ---------------------------------------------------------------------------
# the mesh and its gathers
# ---------------------------------------------------------------------------

class ServeMesh(Mesh):
    """This rank's place in a (data, model) grid of ranks, the two-axis
    case of `launch.mesh.Mesh`: rank r is at (r // n_model, r % n_model).
    `model_group` is the process group of the rank's model axis (None
    for a single model rank)."""

    def __init__(self, n_data, n_model, data=0, model=0, model_group=None,
                 groups=None):
        groups = dict(groups or {})
        if model_group is not None:
            groups[("model",)] = model_group
        super().__init__((n_data, n_model), ("data", "model"),
                         data * n_model + model, groups)

    n_data = property(lambda self: self.shape["data"])
    n_model = property(lambda self: self.shape["model"])
    data = property(lambda self: self.coords["data"])
    model = property(lambda self: self.coords["model"])
    model_group = property(lambda self: self._groups.get(("model",)))


def make_mesh(n_data, n_model):
    """The ServeMesh of this rank in an initialized default process group
    of n_data * n_model ranks (`launch.mesh.make_mesh` over ("data",
    "model")). A 1 x 1 mesh needs no group."""
    m = make_named_mesh((n_data, n_model), ("data", "model"))
    return ServeMesh(n_data, n_model, m.coords["data"], m.coords["model"],
                     groups=m._groups)


def all_gather_rank_major(t, group):
    """(n_ranks,) + t.shape: t of every rank of `group`, in rank order. A
    gloo group gathers CUDA tensors through pinned host memory."""
    return torch.stack(coll.all_gather_group(t, group))


def _gather_model(t, mesh):
    """(B, ...) -> (B, n_model * ...): the model ranks' t side by side,
    rank-major, as jax.lax.all_gather(..., axis=1) then reshape."""
    if mesh.n_model == 1:
        return t
    g = all_gather_rank_major(t, mesh.model_group)       # (nm, B, K)
    return g.transpose(0, 1).reshape(t.shape[0], -1)


def topk_wide(x, k, width=MAX_K):
    """topk_desc_index_asc for a k wider than the topk kernel takes: the
    top `width` at a time, each round's picks set to -inf before the
    next. Every finite entry comes out where one top-k puts it; entries
    of value -inf (padding) may come out at other indices."""
    if k <= width:
        return topk_desc_index_asc(x, k)
    vals, idx = [], []
    x = x.clone()
    for lo in range(0, k, width):
        v, i = topk_desc_index_asc(x, min(width, k - lo))
        vals.append(v)
        idx.append(i)
        x.scatter_(1, i, -torch.inf)
    return torch.cat(vals, 1), torch.cat(idx, 1)


def _occurrence_ranks(docs, real, n=None):
    """(..., P) -> rank of each real entry among the earlier entries of
    its row holding the same doc (0 elsewhere), and one more than the
    largest rank (`n` where the caller knows it: no host sync)."""
    P = docs.shape[-1]
    flat = docs.reshape(-1, P)
    sd, order = torch.sort(flat, dim=1, stable=True)
    pos = torch.arange(P, device=docs.device).expand_as(flat)
    new_run = torch.ones_like(sd, dtype=torch.bool)
    new_run[:, 1:] = sd[:, 1:] != sd[:, :-1]
    start = torch.where(new_run, pos, 0).cummax(1).values
    rank = torch.empty_like(order).scatter_(1, order, pos - start)
    rank = torch.where(real.reshape(-1, P), rank, 0)
    if n is None:
        n = int(rank.max()) + 1 if rank.numel() else 1
    return rank.reshape(docs.shape), n


def _local_sparse_scores(pd_l, pw_l, q_t, q_w, mi, d_local, n_ranks=None):
    """(B, d_local) sparse scores of this rank's docs. A doc's
    contributions are added in the flattened (term, posting) order, as
    JAX's segment_sum adds them: one scatter layer per query term and
    occurrence rank, so no layer adds twice to one doc."""
    B = q_t.shape[0]
    qt = q_t.clamp(min=0).long()
    qmask = (q_t >= 0) & (q_w > 0)
    docs = pd_l[qt][:, :, 0, :]                        # (B, Tq, P_shard)
    ws = pw_l[qt][:, :, 0, :]
    contrib = torch.where(qmask[..., None] & (docs >= 0),
                          ws * q_w[..., None], 0.0)
    local = torch.where(docs >= 0, docs - mi * d_local, d_local)
    local = local.clamp(0, d_local).long()
    rank, n_ranks = _occurrence_ranks(local, docs >= 0, n_ranks)
    scores = torch.zeros((B, d_local + 1), dtype=torch.float32,
                         device=q_t.device)
    for t in range(docs.shape[1]):
        for r in range(n_ranks):
            at = torch.where(rank[:, t] == r, local[:, t], d_local)
            scores.scatter_add_(1, at, torch.where(rank[:, t] == r,
                                                   contrib[:, t], 0.0))
    return scores[:, :d_local]


def make_serve_step(cfg, mesh, bidx_shapes, feat_dim, *, layers=None):
    """The sharded serve function of this rank. bidx_shapes: (N, cap,
    dim, V, P_shard, m); N must divide over the model ranks. `layers`:
    None, or (R, M) where the caller knows them: R the most times a
    posting list holds one doc (1 for an index of distinct (doc, term)
    pairs), M the most entries of one doc in the fusion's merged lists
    (2: each side lists a doc once). Each spares a host sync a batch;
    None counts them from the data.

    serve(blocks_l, pd_l, pw_l, centroids, nb_ids, nb_sims, selector,
          q_dense, q_terms, q_weights) takes this rank's local arrays
    (tensors on one device): its model slice of the blocks (N_local, cap,
    dim) float32 and postings (V, 1, P_shard), the replicated centroids
    and neighbor graph, the Stage-II selector module, and its data slice
    of the queries. Returns that slice's (ids (B, k) int32, scores)."""
    N, cap, dim, V, P_shard, m = bidx_shapes
    nd, nm = mesh.shape["data"], mesh.shape["model"]
    if N % nm:
        raise ValueError(f"{N} clusters do not split over {nm} model ranks")
    n_local = N // nm
    d_local = n_local * cap
    k = cfg.k_sparse
    sentinel = N * cap + 1
    kk = min(k, d_local)
    kd = min(cfg.max_selected * cap, 4 * k)
    k_out = min(cfg.k_final, k)
    n_occ, n_merge = layers or (None, None)

    def serve(blocks_l, pd_l, pw_l, centroids, nb_ids, nb_sims, selector,
              q_dense, q_terms, q_weights):
        mi = mesh.model
        dev = q_dense.device
        q_d = q_dense.float().contiguous()
        B = q_d.shape[0]
        # ---- 1: sparse scoring at the doc owner, local top-k, merge ----
        s_scores = _local_sparse_scores(pd_l, pw_l, q_terms, q_weights, mi,
                                        d_local, n_occ)
        sv, si = topk_desc_index_asc(s_scores, kk)
        gid = si + mi * d_local
        sv_f = _gather_model(sv, mesh)                     # (B, nm * kk)
        gid_f = _gather_model(gid, mesh)
        sparse_scores, mi_ = topk_desc_index_asc(sv_f, k)
        sparse_ids = gid_f.gather(1, mi_)
        # ---- 2: Stage I/II, replicated across the model ranks ----
        qc_sim = q_d @ centroids.T                         # (B, N)
        bin_ids = bins_lib.rank_bin_ids(cfg.bins, k, device=dev)
        sn = fusion_lib.minmax_norm(sparse_scores)
        P_, Q_ = bin_overlap_ops.bin_overlap(
            (sparse_ids // cap).int(), bin_ids, sn.float().contiguous(),
            n_clusters=N, v=cfg.v_bins)
        cand = stage1_lib.sort_by_overlap(P_, qc_sim, cfg.n_candidates)
        feats = feat_lib.candidate_features(
            cand, qc_sim, P_, Q_, nb_ids, nb_sims, cfg.u_bins)
        probs = selector(feats)
        picked = probs >= cfg.theta
        masked = torch.where(picked, probs, -1.0)
        top_p, top_i = topk_desc_index_asc(masked, cfg.max_selected)
        sel_mask = top_p >= 0.0
        sel_ids = cand.gather(1, top_i).long()             # (B, S)
        # ---- 3: score the selected clusters this rank owns ----
        local_sel = sel_ids - mi * n_local
        owned = (local_sel >= 0) & (local_sel < n_local) & sel_mask
        dsc = cluster_score(q_d, blocks_l,
                            local_sel.clamp(0, n_local - 1).int())
        dsc = torch.where(owned[:, :, None], dsc, -torch.inf)
        d_ids = sel_ids[:, :, None] * cap \
            + torch.arange(cap, device=dev)[None, None, :]
        dv, di = topk_wide(dsc.reshape(B, -1), kd)
        dgid = d_ids.reshape(B, -1).gather(1, di)
        dv_all = _gather_model(dv, mesh)                   # (B, nm * kd)
        dg_all = _gather_model(dgid, mesh)
        # ---- 4: sort-merge fusion ----
        dmask = torch.isfinite(dv_all)
        return fusion_lib.fuse_topk_merge(
            sparse_ids, sparse_scores, dg_all,
            torch.where(dmask, dv_all, 0.0), dmask, cfg.alpha, k_out,
            sentinel, method=cfg.fusion, rrf_k=cfg.rrf_k, n_layers=n_merge)

    return serve


class ServeRunner:
    """This rank's serve step with its arrays on `device` (None: the CUDA
    card): the model slice of the blocks and postings, the replicated
    centroids, neighbor graph and selector. Called with a whole query
    batch (numpy), it serves this rank's data slice of it and returns
    that slice's (ids, scores) on the device.

    blocks_l: (N / n_model, cap, dim) float32, this rank's clusters;
    postings_docs/weights: (V, n_model, P_shard) from postings_by_owner;
    numpy arrays or tensors (moved to `device`, tensors without a host
    round trip)."""

    def __init__(self, cfg, mesh, blocks_l, postings_docs, postings_weights,
                 centroids, neighbor_ids, neighbor_sims, selector, *,
                 device=None):
        import copy
        dev = resolve_device(device)
        self.device, self.mesh, self.cfg = dev, mesh, cfg
        nm, mi = mesh.n_model, mesh.model
        N = centroids.shape[0]
        cap, dim = blocks_l.shape[1], blocks_l.shape[2]
        if blocks_l.shape[0] * nm != N:
            raise ValueError(f"blocks of {blocks_l.shape[0]} clusters are "
                             f"not 1/{nm} of {N}")

        def t(x):
            if isinstance(x, torch.Tensor):
                return x.to(dev).contiguous()
            # a read-only array (an np.memmap) is copied first
            return torch.from_numpy(np.require(x, requirements="CW")).to(dev)
        self.blocks = t(blocks_l)
        self.pd = t(postings_docs[:, mi:mi + 1])
        self.pw = t(postings_weights[:, mi:mi + 1])
        self.centroids = t(centroids)
        self.nb_ids, self.nb_sims = t(neighbor_ids), t(neighbor_sims)
        self.selector = copy.deepcopy(selector).to(dev)
        V, _, P_shard = self.pd.shape
        self.step = make_serve_step(
            cfg, mesh, (N, cap, dim, V, P_shard, self.nb_ids.shape[1]),
            feat_lib.feature_dim(cfg))

    @classmethod
    def from_blocked(cls, cfg, mesh, bidx, *, device=None):
        """A runner over a whole BlockedIndex, of which it keeps this
        rank's model slice."""
        nm, mi = mesh.n_model, mesh.model
        n_local = bidx.n_clusters // nm
        pd, pw = shard_postings_by_owner(bidx, nm)
        return cls(cfg, mesh, bidx.blocks[mi * n_local:(mi + 1) * n_local],
                   pd, pw, bidx.centroids, bidx.neighbor_ids,
                   bidx.neighbor_sims, bidx.selector, device=device)

    def data_slice(self, n):
        """[lo, hi) of this rank's rows in a batch of n queries."""
        nd, d = self.mesh.n_data, self.mesh.data
        if n % nd:
            raise ValueError(f"{n} queries do not split over {nd} data "
                             f"ranks")
        return d * (n // nd), (d + 1) * (n // nd)

    def __call__(self, q_dense, q_terms, q_weights):
        lo, hi = self.data_slice(len(q_dense))
        return self.serve(q_dense[lo:hi], q_terms[lo:hi], q_weights[lo:hi])

    def serve(self, q_dense, q_terms, q_weights):
        """The serve step over these query rows (numpy), whatever this
        rank's data slice; every model rank of the group must call it
        with the same rows."""
        dev = self.device

        def t(x, dtype):                 # a copy: x may be read-only
            return torch.tensor(np.asarray(x), dtype=dtype).to(dev)
        with torch.inference_mode():
            return self.step(self.blocks, self.pd, self.pw, self.centroids,
                             self.nb_ids, self.nb_sims, self.selector,
                             t(q_dense, torch.float32),
                             t(q_terms, torch.int32),
                             t(q_weights, torch.float32))
