"""Public overlap-feature op (Stage I's P and Q). CPU tensors take the
plain version (ref.py); CUDA tensors launch the kernel of
csrc/bin_overlap.cu after the checks below, or raise: a failed build or
launch is an error, never a switch to ref."""

import torch

from repro_torch.kernels import on_cuda, record_launch, require
from repro_torch.kernels.bin_overlap import kernel
from repro_torch.kernels.bin_overlap.ref import bin_overlap_ref

MAX_K = 2048            # csrc/bin_overlap.cu kMaxK


def bin_overlap(cluster_of, bin_ids, scores, *, n_clusters, v):
    """cluster_of: (B, k) int32 cluster of each sparse result; bin_ids:
    (k,) or (B, k) int32 rank bin of each result; scores: (B, k) float32.
    Returns (P, Q), each (B, n_clusters, v) float32: P counts the results
    of cluster c in bin j, Q is their mean score (Qsum / max(P, 1))."""
    B, k = cluster_of.shape
    if not on_cuda(cluster_of, bin_ids, scores):
        return bin_overlap_ref(cluster_of, bin_ids, scores,
                               n_clusters=n_clusters, v=v)
    require(cluster_of, "cluster_of", torch.int32, 2)
    require(bin_ids, "bin_ids", torch.int32, bin_ids.dim())
    require(scores, "scores", torch.float32, 2)
    if tuple(scores.shape) != (B, k) or bin_ids.dim() not in (1, 2) \
            or tuple(bin_ids.shape) not in ((k,), (B, k)):
        raise ValueError(f"shape mismatch: cluster_of "
                         f"{tuple(cluster_of.shape)}, bin_ids "
                         f"{tuple(bin_ids.shape)}, scores "
                         f"{tuple(scores.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} is outside the kernel's 1..{MAX_K}")
    if n_clusters < 1 or v < 1 or n_clusters * v >= 2 ** 31 - 1:
        raise ValueError(f"bad geometry n_clusters={n_clusters}, v={v}")
    P = torch.empty((B, n_clusters, v), dtype=torch.float32,
                    device=scores.device)
    Q = torch.empty_like(P)
    if B == 0:
        return P, Q
    with torch.cuda.device(scores.device):
        kernel.bin_overlap_cuda(cluster_of, bin_ids, scores, P, Q,
                                n_clusters, v)
    record_launch("bin_overlap")
    return P, Q
