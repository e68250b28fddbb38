"""Position bins over sparse top-k results and the P/Q cluster-overlap
features (paper §2.2): P(C_i, B_j) = |C_i ∩ B_j| (count overlap) and
Q(C_i, B_j) = mean sparse score of docs in C_i ∩ B_j (score overlap).

The features come from the bin_overlap kernel on the card
(repro_torch.kernels.bin_overlap: no atomics, each slot's scores summed
in rank order) and from its plain scatter-add version on the CPU; both
give the JAX package's segment_sum bit for bit.
"""

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.bin_overlap import ops as bin_overlap_ops


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
    c_of = doc_cluster[top_ids.long()].int()               # (B, k)
    return bin_overlap_ops.bin_overlap(
        c_of, bin_ids.int().contiguous(), top_scores.float().contiguous(),
        n_clusters=n_clusters, v=v)
