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
        return torch.where(mask, weight / (rrf_k + r), 0.0)
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
