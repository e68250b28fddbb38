"""CluSD as a first-class feature for recsys candidate retrieval (the
`retrieval_cand` shape: one query against 1M candidates), a port of
repro.core.retrieval.

Mapping of the paper onto the recsys setting:
  sparse lexical retrieval  -> cheap guide scores: the model's wide/linear
                               branch (wide-deep, deepfm) or a low-dim
                               prefix dot (dlrm, din)
  dense embedding clusters  -> k-means clusters of candidate item vectors,
                               cluster-blocked layout (n_clusters, cap, d)
  Stage I/II                 -> identical: bin-overlap multikey sort + LSTM
  partial dense retrieval    -> full-dim dot only on selected cluster blocks

On the card a query runs the embedding_bag kernel (user tower, guide),
the topk kernel (guide top-k, Stage-II budget, fuse), bin_overlap (Stage
I's P and Q, which the JAX function computes with two inline
segment_sums) and lstm_sequence (Stage II). With `local_topk` the guide
top-k is shard-local over the ranks of a torch.distributed group.
"""

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import bins as bins_lib
from repro_torch.core import features as feat_lib
from repro_torch.core import fusion as fusion_lib
from repro_torch.core import stage1 as stage1_lib
from repro_torch.core.distributed import all_gather_rank_major
from repro_torch.core.fusion import topk_desc_index_asc
from repro_torch.kernels.bin_overlap import ops as bin_overlap_ops
from repro_torch.models import recsys as rs


@dataclasses.dataclass(frozen=True)
class CandidateIndexSpec:
    """Static geometry of the candidate-side CluSD index."""
    n_candidates: int
    n_clusters: int = 4096
    cap: int = 512                 # cluster block size (padded)
    guide_dim: int = 16            # prefix-dot guide width (dlrm/din)
    k_guide: int = 1024            # guide retrieval depth (= paper's k)
    bins: tuple = (10, 25, 50, 100, 200, 500, 1024)
    n_candidates_stage1: int = 32  # n
    u_bins: int = 6
    max_selected: int = 32
    theta: float = 0.02
    alpha: float = 0.5
    k_final: int = 100
    local_topk: bool = False       # shard-local guide top-k merge

    @property
    def v_bins(self):
        return len(self.bins)


def guide_scores(cfg, params, u, item_vecs, cand_sparse):
    """Cheap guide over ALL candidates (the 'sparse retrieval' analogue)."""
    if cfg.kind in ("wide_deep", "deepfm"):
        return rs._params(params)["wide"].bag(cand_sparse)[:, 0]
    # low-dim prefix dot (PQ-style coarse scorer)
    gd = min(16, item_vecs.shape[1])
    return item_vecs[:, :gd] @ u[0, :gd]


def _guide_topk(g, spec):
    """Guide-phase top-k over the (n,) guide scores.

    With `spec.local_topk` every rank of the initialized default process
    group takes the top-k of its contiguous slice of g, the ranks
    all-gather (values, global ids) — wire bytes n_ranks * k * 12
    instead of the whole score vector — and the concatenation in rank
    order is ranked again. That is the global top-k: within a rank the
    ties come index asc, and a lower rank holds lower ids. Without a
    process group it raises; it never falls back to the global top-k."""
    if not spec.local_topk:
        vals, ids = topk_desc_index_asc(g[None], spec.k_guide)
        return vals[0], ids[0]
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("local_topk=True shards the guide top-k over the "
                           "ranks of a torch.distributed process group; "
                           "none is initialized")
    nm, r = dist.get_world_size(), dist.get_rank()
    if g.shape[0] % nm:
        raise ValueError(f"{g.shape[0]} candidates do not split over {nm} "
                         f"ranks")
    shard = g.shape[0] // nm
    kk = min(spec.k_guide, shard)
    v, i = topk_desc_index_asc(g[None, r * shard:(r + 1) * shard], kk)
    v_all = all_gather_rank_major(v[0], None)             # (nm, kk)
    g_all = all_gather_rank_major(i[0] + r * shard, None)
    mv, mi = topk_desc_index_asc(v_all.reshape(1, -1), spec.k_guide)
    return mv[0], g_all.reshape(-1)[mi[0]]


def clusd_candidate_retrieval(model_cfg, spec: CandidateIndexSpec, params,
                              batch, cand_sparse, item_blocks, centroids,
                              selector, neighbor_ids, neighbor_sims,
                              slot_valid=None):
    """One query against spec.n_candidates items, CluSD-accelerated.

    params: a RecsysModel or its params dict; selector: an LSTMSelector
    (repro_torch.convert.selector_from_numpy for JAX lstm params).
    item_blocks: (N, cap, d) cluster-blocked candidate vectors — candidate
    id == c * cap + slot. slot_valid (N*cap,) masks pad slots out of the
    guide (pad slots otherwise alias item id 0 in the wide branch).
    Returns (ids (k_final,) int32, scores, {"n_selected"}).
    """
    N, cap, d = item_blocks.shape
    dev = item_blocks.device
    u = rs.user_tower(model_cfg, params, batch)            # (1, d)

    flat_items = item_blocks.reshape(N * cap, d)
    g = guide_scores(model_cfg, params, u, flat_items, cand_sparse)
    if slot_valid is not None:
        g = torch.where(slot_valid, g, -torch.inf)
    g_scores, g_ids = _guide_topk(g, spec)                 # (k,)

    # Stage I: overlap of guide top-k with clusters (cluster = id // cap);
    # P counts, Q the mean min-max-normed guide score per (cluster, bin)
    bin_ids = bins_lib.rank_bin_ids(spec.bins, spec.k_guide, device=dev)
    gn = fusion_lib.minmax_norm(g_scores[None])
    P, Q = bin_overlap_ops.bin_overlap(
        (g_ids // cap)[None].int(), bin_ids, gn.float().contiguous(),
        n_clusters=N, v=spec.v_bins)
    qc_sim = (centroids @ u[0])[None]                      # (1, N)
    cand = stage1_lib.sort_by_overlap(P, qc_sim, spec.n_candidates_stage1)

    feats = feat_lib.candidate_features(
        cand, qc_sim, P, Q, neighbor_ids, neighbor_sims, spec.u_bins)
    probs = selector(feats)                                # (1, n)
    picked = probs >= spec.theta
    masked = torch.where(picked, probs, -1.0)
    top_p, top_i = topk_desc_index_asc(masked, spec.max_selected)
    sel_mask = top_p >= 0.0
    sel_ids = cand.gather(1, top_i)[0]                     # (S,)

    # Step 3: full-dim dot on selected blocks only
    blocks = item_blocks[sel_ids.long()]                   # (S, cap, d)
    dscore = torch.einsum("d,scd->sc", u[0], blocks)
    dscore = torch.where(sel_mask[0][:, None], dscore, -torch.inf)
    did = (sel_ids[:, None] * cap
           + torch.arange(cap, device=dev)[None, :]).reshape(-1)
    dscore = dscore.reshape(-1)
    dmask = torch.isfinite(dscore)

    ids, scores = fusion_lib.fuse_topk(
        g_ids[None], g_scores[None], did[None].int(),
        torch.where(dmask, dscore, 0.0)[None], dmask[None],
        N * cap, spec.alpha, spec.k_final)
    return ids[0], scores[0], {"n_selected": sel_mask.sum()}


def brute_force_retrieval(model_cfg, params, batch, item_blocks, k=100):
    """Baseline: full dot over all candidates."""
    N, cap, d = item_blocks.shape
    u = rs.user_tower(model_cfg, params, batch)
    scores = item_blocks.reshape(N * cap, d) @ u[0]
    s, i = topk_desc_index_asc(scores[None], k)
    return i[0].int(), s[0]
