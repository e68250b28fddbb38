"""Public selected-cluster scoring op. CPU tensors take the plain version
(ref.py); CUDA tensors launch the kernel of csrc/cluster_score.cu after
the checks below, or raise: a failed build or launch is an error, never
a switch to ref."""

import torch

from repro_torch.kernels import on_cuda, record_launch, require
from repro_torch.kernels.cluster_score import kernel
from repro_torch.kernels.cluster_score.ref import cluster_score_ref

# what a block may use (H100: 227 KB of its SM's shared memory)
MAX_SMEM_BYTES = 232448


def cluster_score(q, blocks, sel_ids):
    """q: (B, dim) float32; blocks: (U, cap, dim) float32; sel_ids: (B, S)
    int32 positions into blocks, 0 <= sel < U. Returns (B, S, cap)
    float32 scores. An empty selection (S, cap or U of 0) scores to
    zeros of the contract shape without a launch."""
    B, S = sel_ids.shape[0], sel_ids.shape[1]
    cap = blocks.shape[1]
    if B == 0 or S == 0 or cap == 0 or blocks.shape[0] == 0:
        return torch.zeros((B, S, cap), dtype=torch.float32, device=q.device)
    if not on_cuda(q, blocks, sel_ids):
        return cluster_score_ref(q, blocks, sel_ids)
    require(q, "q", torch.float32, 2)
    require(blocks, "blocks", torch.float32, 3)
    require(sel_ids, "sel_ids", torch.int32, 2)
    if q.shape[0] != B or blocks.shape[2] != q.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, blocks "
                         f"{tuple(blocks.shape)}, sel_ids "
                         f"{tuple(sel_ids.shape)}")
    smem = kernel.smem_bytes(q.shape[1])
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"a query of dim {q.shape[1]} needs {smem} bytes of "
                         f"shared memory, over the {MAX_SMEM_BYTES} a block "
                         f"has")
    out = torch.empty((B, S, cap), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        kernel.cluster_score_cuda(q, blocks, sel_ids, out)
    record_launch("cluster_score")
    return out
