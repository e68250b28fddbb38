"""Position bins over sparse top-k results and the P/Q cluster-overlap
features (paper §2.2): P(C_i, B_j) = |C_i ∩ B_j| (count overlap) and
Q(C_i, B_j) = mean sparse score of docs in C_i ∩ B_j (score overlap).

The segment-sum form of the JAX path, as two scatter-adds into a
(B, N*v) buffer. Counts are exact in any order; the score sums are
atomic on CUDA, so Q differs from the CPU's in the last bits.
"""

import numpy as np
import torch

from repro_torch.device import resolve_device


def rank_bin_ids(bins, k, *, device=None):
    """Map rank position 0..k-1 to bin id given cumulative edges, e.g.
    (10, 25, 50, 100, 200, 500, 1000) -> 7 bins. (k,) int32."""
    ids = np.searchsorted(np.asarray(bins), np.arange(k), side="right")
    return torch.as_tensor(ids, dtype=torch.int32,
                           device=resolve_device(device))


def overlap_features(top_ids, top_scores, doc_cluster, n_clusters, bin_ids, v):
    """P and Q features for ALL clusters.

    top_ids: (B, k) sparse top-k doc ids; top_scores: (B, k);
    doc_cluster: (D,) cluster of each doc; bin_ids: (k,) bin of each
    rank. Returns P, Q: (B, N, v) float32.
    """
    B, k = top_ids.shape
    c_of = doc_cluster[top_ids.long()].long()              # (B, k)
    slot = c_of * v + bin_ids[None, :].long()              # (B, k)
    cnt = torch.zeros((B, n_clusters * v), dtype=torch.float32,
                      device=top_ids.device)
    cnt.scatter_add_(1, slot, torch.ones_like(top_scores, dtype=torch.float32))
    ssum = torch.zeros_like(cnt).scatter_add_(1, slot, top_scores.float())
    P = cnt.reshape(B, n_clusters, v)
    Q = (ssum / cnt.clamp(min=1.0)).reshape(B, n_clusters, v)
    return P, Q
