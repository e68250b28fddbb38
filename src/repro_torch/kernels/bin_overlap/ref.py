"""Plain PyTorch P/Q overlap features (the CPU path, and what the CUDA
kernel is held to): two scatter-adds over combined (cluster, bin) slots.
On the CPU, scatter_add_ adds a row's entries in index order, as XLA's
CPU segment_sum does, so P and Q are bitwise the JAX package's."""

import torch


def bin_overlap_ref(cluster_of, bin_ids, scores, *, n_clusters, v):
    """cluster_of: (B, k) cluster of each result; bin_ids: (k,) or (B, k)
    rank bin of each result; scores: (B, k). Returns P (counts) and Q
    (mean scores), each (B, n_clusters, v) float32."""
    B, k = cluster_of.shape
    bins = bin_ids.expand(B, k) if bin_ids.dim() == 1 else bin_ids
    slot = cluster_of.long() * v + bins.long()
    cnt = torch.zeros((B, n_clusters * v), dtype=torch.float32,
                      device=cluster_of.device)
    cnt.scatter_add_(1, slot, torch.ones((B, k), dtype=torch.float32,
                                         device=cluster_of.device))
    ssum = torch.zeros_like(cnt).scatter_add_(1, slot, scores.float())
    P = cnt.reshape(B, n_clusters, v)
    Q = (ssum / cnt.clamp(min=1.0)).reshape(B, n_clusters, v)
    return P, Q
