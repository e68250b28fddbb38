"""Public row-wise top-k op. CPU tensors take the plain version (ref.py);
CUDA tensors launch the kernels of csrc/topk.cu after the checks below,
or raise: a failed build or launch is an error, never a switch to ref.

A CUDA call cuts each row into C chunks (`kernel.plan`): C == 1 is one
device kernel; C > 1 is two (select per chunk, merge per row) with a
(2, B * C * kstride) int32 scratch from torch.empty between them. The
launch count (`LAUNCHES["topk"]`) is one per call either way."""

import functools

import torch

from repro_torch.kernels import on_cuda, record_launch
from repro_torch.kernels.topk import kernel
from repro_torch.kernels.topk.ref import topk_ref

MAX_K = 2048            # csrc/topk.cu kMaxK
MAX_D = (1 << 31) - 1   # int32 positions inside the kernel


@functools.lru_cache(maxsize=256)
def chunking(B, D, k, device_index):
    """(C, L, kstride) for (B, D) rows on the card `device_index`."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return kernel.plan(B, D, k, sms)


def topk(x, k):
    """The k largest entries of each row of x, ordered (value desc, index
    asc) as `jax.lax.top_k` orders them. Returns (values float32, indices
    int64) of shape (..., k).

    CPU tensors of any rank (..., D) take the plain version. On CUDA, x
    must be (B, D) float32 with contiguous rows; the rows themselves may
    lie at any stride (a view such as `buf[:, :n]` is read in place).
    """
    D = x.shape[-1]
    if not 0 <= k <= D:
        raise ValueError(f"k={k} out of range for rows of length {D}")
    if not on_cuda(x):
        return topk_ref(x, k)
    if x.dtype != torch.float32:
        raise TypeError(f"x must be torch.float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (B, D), got shape {tuple(x.shape)}")
    if k > MAX_K:
        raise ValueError(f"k={k} is over the {MAX_K} the kernel takes")
    if D > MAX_D:
        raise ValueError(f"rows of {D} entries are over the kernel's "
                         f"{MAX_D}")
    if D > 1 and x.stride(1) != 1:
        raise ValueError("x must have contiguous rows (unit stride along "
                         "the last dimension)")
    B = x.shape[0]
    vals = torch.empty((B, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, k), dtype=torch.long, device=x.device)
    if B == 0 or k == 0:
        return vals, idx
    with torch.cuda.device(x.device):
        chunks = chunking(B, D, k, x.device.index)
        C, _, kstride = chunks
        scratch = (torch.empty(2 * B * C * kstride, dtype=torch.int32,
                               device=x.device) if C > 1 else None)
        kernel.topk_cuda(x, k, vals, idx, scratch, chunks)
    record_launch("topk")
    return vals, idx
