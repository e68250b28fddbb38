"""Score fusion (paper Step 3): combine the per-query top results of the
sparse and dense retrievers into one ranked list.

  method="interp": min-max normalize each side's VALID entries, then
      alpha*sparse + (1-alpha)*dense. A doc reached by only one side
      contributes 0 on the other.
  method="rrf": weighted reciprocal-rank fusion, alpha / (rrf_k + r_s) +
      (1-alpha) / (rrf_k + r_d), with 1-based ranks among each side's
      valid entries ordered (score desc, position asc).

Both sides carry a validity mask; masked entries contribute 0 and are
left out of the min-max range and of the ranks.

Two formulations, one semantics:

  fuse_topk        the (B, n_docs + 1) scatter-add buffer, ranked by the
      top-k (the serving engine's; a doc gets at most two addends).
  fuse_topk_merge  sort-merge without the O(n_docs) buffer: the entries
      are stably sorted by id and each id's run is folded in sorted
      order, so a doc may appear any number of times across (and
      within) the two lists (the distributed serve step's gathers).

Ties: `lax.top_k` returns ties in ascending index order; `torch.topk`
promises no order among them. `topk_desc_index_asc` applies the rule
explicitly and is the port's one top-k (sparse retrieval, Stage-I
sort-by-distance, Stage-II budget, the neighbor graph, the full dense
top-k and this fuse): the topk kernel on the card.
"""

import torch

from repro_torch.kernels.topk import ops as topk_ops

FUSION_METHODS = ("interp", "rrf")


def topk_desc_index_asc(x, k):
    """The k largest entries of each row of x (..., D), ordered (value
    desc, index asc) — `jax.lax.top_k`'s rule, with its total order of
    floats (-0.0 below +0.0). Returns (values, indices int64).

    On CUDA tensors this is the topk kernel (repro_torch.kernels.topk),
    which reads a row-strided view such as `fused[:, :n_docs]` in place;
    on CPU tensors its plain version.
    """
    return topk_ops.topk(x, k)


def minmax_norm(scores, mask=None):
    """Per-row min-max over valid entries. scores: (B, K)."""
    if mask is None:
        mask = torch.ones_like(scores, dtype=torch.bool)
    big = torch.where(mask, scores, -torch.inf)
    small = torch.where(mask, scores, torch.inf)
    mx = big.amax(-1, keepdim=True)
    mn = small.amin(-1, keepdim=True)
    rng = torch.clamp(mx - mn, min=1e-9)
    out = (scores - mn) / rng
    return torch.where(mask, out.clamp(0.0, 1.0), 0.0)


def rank_desc(scores, mask):
    """1-based rank of every entry among its row's VALID entries, ordered
    (score desc, position asc). Invalid entries rank after every valid
    one. scores/mask: (B, K) -> (B, K) int32."""
    keyed = torch.where(mask, scores, -torch.inf)
    order = torch.argsort(-keyed, dim=-1, stable=True)
    inv = torch.argsort(order, dim=-1, stable=True)     # inverse permutation
    return (inv + 1).int()


def side_contrib(scores, mask, weight, method, rrf_k):
    """Per-entry fused-score contribution of one retriever side; masked
    entries contribute exactly 0 either way."""
    if method == "interp":
        return weight * minmax_norm(scores, mask)
    if method == "rrf":
        r = rank_desc(scores, mask).to(scores.dtype)
        # a true division, as JAX divides: `weight / tensor` would be
        # weight * reciprocal(tensor), another rounding
        w = torch.full_like(r, weight)
        return torch.where(mask, w / (rrf_k + r), 0.0)
    raise ValueError(f"unknown fusion method {method!r}; "
                     f"expected one of {FUSION_METHODS}")


def fuse_buffer(sparse_ids, sparse_scores, dense_ids, dense_scores,
                dense_mask, n_docs, alpha, *, sparse_mask=None,
                method="interp", rrf_k=60.0):
    """The (B, n_docs + 1) fused-score buffer that fuse_topk ranks: each
    side's contributions scatter-added at their doc ids, masked entries
    into the dump column n_docs.

    A doc gets at most one addend from each side (the serving path
    feeds duplicate-free lists), and two addends onto 0.0 give the same
    sum in either order, so the atomic CUDA scatter is exact."""
    if sparse_mask is None:
        sparse_mask = torch.ones_like(sparse_ids, dtype=torch.bool)
    s_c = side_contrib(sparse_scores, sparse_mask, alpha, method, rrf_k)
    d_c = side_contrib(dense_scores, dense_mask, 1.0 - alpha, method, rrf_k)
    B = sparse_ids.shape[0]
    fused = torch.zeros((B, n_docs + 1), dtype=torch.float32,
                        device=sparse_ids.device)
    fused.scatter_add_(1, torch.where(dense_mask, dense_ids, n_docs).long(),
                       d_c.float())
    fused.scatter_add_(1, torch.where(sparse_mask, sparse_ids, n_docs).long(),
                       s_c.float())
    return fused


def fuse_topk(sparse_ids, sparse_scores, dense_ids, dense_scores, dense_mask,
              n_docs, alpha, k, *, sparse_mask=None, method="interp",
              rrf_k=60.0):
    """Union-merge + fuse + global top-k over the fuse_buffer.

    sparse_ids/scores: (B, Ks), optional sparse_mask; dense_ids/scores:
    (B, Kd) with dense_mask. Returns (ids (B, k) int32, scores (B, k)).
    The top-k reads the buffer's first n_docs columns in place."""
    fused = fuse_buffer(sparse_ids, sparse_scores, dense_ids, dense_scores,
                        dense_mask, n_docs, alpha, sparse_mask=sparse_mask,
                        method=method, rrf_k=rrf_k)
    scores, ids = topk_desc_index_asc(fused[:, :n_docs], k)
    return ids.int(), scores


def _fold_runs(c_s, seg, rank, n_layers):
    """Per-segment sums of c_s (B, L) in sorted order: layer r adds each
    run's r-th entry, so a run of length m is ((0.0 + c0) + c1) + ... in
    order, as a serial segment_sum adds it. No layer adds twice to one
    segment (the CUDA scatter meets no collision but in the dump column
    L, which is dropped)."""
    B, L = c_s.shape
    totals = torch.zeros((B, L + 1), dtype=torch.float32, device=c_s.device)
    for r in range(n_layers):
        at = torch.where(rank == r, seg, L)
        totals.scatter_add_(1, at, torch.where(rank == r, c_s, 0.0))
    return totals[:, :L]


def fuse_topk_merge(sparse_ids, sparse_scores, dense_ids, dense_scores,
                    dense_mask, alpha, k, sentinel, *, sparse_mask=None,
                    method="interp", rrf_k=60.0, n_layers=None):
    """Sort-merge fusion without an O(n_docs) buffer.

    The masked ids become `sentinel` (an id above every real doc id); the
    (B, Ks + Kd) entries are sorted stably by id (on equal ids the sparse
    entries first, as they come first in the concatenation), each id's
    run is folded by `_fold_runs`, and the top-k of the run totals is
    taken under (value desc, id asc) by `topk_desc_index_asc`. A doc may
    appear any number of times. `n_layers`, the most entries one doc
    holds, where the caller knows it (2 when neither side lists a doc
    twice), spares the host sync that counts it. Returns (ids (B, k)
    int32, scores)."""
    if sparse_mask is None:
        sparse_mask = torch.ones_like(sparse_ids, dtype=torch.bool)
    s_c = side_contrib(sparse_scores, sparse_mask, alpha, method, rrf_k)
    d_c = side_contrib(dense_scores, dense_mask, 1.0 - alpha, method, rrf_k)
    ids = torch.cat([torch.where(sparse_mask, sparse_ids.long(), sentinel),
                     torch.where(dense_mask, dense_ids.long(), sentinel)], 1)
    contrib = torch.cat([s_c.float(), d_c.float()], 1)  # masked: already 0
    ids_s, order = torch.sort(ids, dim=1, stable=True)
    c_s = contrib.gather(1, order)
    B, L = ids_s.shape
    first = torch.ones_like(ids_s, dtype=torch.bool)
    first[:, 1:] = ids_s[:, 1:] != ids_s[:, :-1]
    seg = torch.cumsum(first, 1) - 1                       # (B, L) run index
    pos = torch.arange(L, device=ids.device).expand(B, L)
    rank = pos - torch.where(first, pos, 0).cummax(1).values
    # the sentinel run (the masked entries) is never folded
    real = ids_s < sentinel
    if n_layers is None:
        n_layers = int(rank[real].max()) + 1 if bool(real.any()) else 0
    totals = _fold_runs(c_s, seg, rank, n_layers)
    # each run's id at its run index (the other entries go to the dump
    # column L); indices past the last run keep the sentinel
    seg_ids = torch.full((B, L + 1), sentinel, dtype=torch.long,
                         device=ids.device)
    seg_ids.scatter_(1, torch.where(first, seg, L), ids_s)
    seg_ids = seg_ids[:, :L]
    live = seg_ids < sentinel
    final = torch.where(live, totals, -torch.inf)
    top_s, top_i = topk_desc_index_asc(final, k)
    return seg_ids.gather(1, top_i).int(), top_s
