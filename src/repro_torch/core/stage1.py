"""Stage I of Step 2: preliminary top-n cluster selection (paper §2.2).

SortByOverlap: multikey sort on the priority vector (P(C,B_1), ...,
P(C,B_v)), ties broken by query-centroid similarity, as v+1 passes of a
stable argsort (exact lexicographic order). SortByDist: the IVF-style
ordering. expand_candidates: neighbor-graph expansion of the seeds with
a static output width. All functions are batched over queries.
"""

import torch

from repro_torch.core.fusion import topk_desc_index_asc


def _lexsort_desc(keys):
    """keys: list of (B, N) tensors, primary first. Descending. Returns
    (B, N) int64 permutations."""
    B, N = keys[0].shape
    perm = torch.arange(N, device=keys[0].device).expand(B, N)
    # least-significant pass first (stable sorts compose lexicographically)
    for key in reversed(keys):
        k = key.gather(1, perm)
        order = torch.argsort(-k, dim=1, stable=True)
        perm = perm.gather(1, order)
    return perm


def sort_by_overlap(P, qc_sim, n):
    """P: (B, N, v); qc_sim: (B, N). Returns (B, n) int32 cluster ids,
    best first."""
    keys = [P[:, :, j] for j in range(P.shape[2])] + [qc_sim]
    return _lexsort_desc(keys)[:, :n].int()


def sort_by_dist(qc_sim, n):
    """IVF ordering: top-n clusters by query-centroid similarity. (B, n)."""
    _, ids = topk_desc_index_asc(qc_sim, n)
    return ids.int()


def expand_candidates(cand, neighbor_ids, neighbor_sims, qc_sim, depth,
                      n_out):
    """Proximity-expand stage-1 seed clusters through the neighbor graph.

    cand: (B, n) seeds in stage-1 order; neighbor_ids/sims: (N, m);
    qc_sim: (B, N); depth: neighbors per seed (clamped to m); n_out:
    static output width. Returns (B, n_out) int32, distinct per row: the
    seeds, then graph-reached clusters by their best edge similarity to
    any seed, then the nearest untouched clusters by qc_sim.
    """
    B, n = cand.shape
    N = qc_sim.shape[1]
    ext = int(n_out) - n
    if ext <= 0 or depth <= 0:
        return cand
    if ext > N - n:
        raise ValueError(f"n_out={n_out} exceeds n_clusters={N}")
    depth = min(int(depth), neighbor_ids.shape[1])
    cl = cand.long()
    nb_i = neighbor_ids[cl][:, :, :depth].reshape(B, -1).long()
    nb_s = neighbor_sims[cl][:, :, :depth].reshape(B, -1)
    reach = torch.full((B, N), -torch.inf, dtype=nb_s.dtype,
                       device=cand.device)
    reach.scatter_reduce_(1, nb_i, nb_s, reduce="amax")
    is_seed = torch.zeros((B, N), dtype=torch.bool, device=cand.device)
    is_seed.scatter_(1, cl, True)
    reach = torch.where(is_seed, -torch.inf, reach)
    reached = reach > -torch.inf
    score = torch.where(reached, reach,
                        torch.where(is_seed, -torch.inf, qc_sim))
    perm = _lexsort_desc([reached.float(), score])
    return torch.cat([cand, perm[:, :ext].int()], dim=1)
