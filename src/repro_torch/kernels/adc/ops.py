"""Public ADC ops: LUT build and code-block scoring.

CPU tensors take the plain versions (ref.py). CUDA tensors launch the
kernels of csrc/adc.cu after the checks below, or raise; a failed build
or launch is an error, never a switch to ref.
"""

import torch

from repro_torch.kernels import on_cuda, record_launch, require
from repro_torch.kernels.adc import kernel
from repro_torch.kernels.adc.ref import (adc_score_blocks_ref, adc_tables_ref,
                                         rotate)

# what a block may use (H100: 227 KB of its SM's shared memory)
MAX_SMEM_BYTES = 232448


def adc_tables(q, codebooks, rotation=None):
    """q: (B, dim) -> LUT (B, nsub, K) float32. The OPQ rotation is folded
    in here as a matmul (q is rotated once; codes are scored
    rotation-free); the kernel sees only the rotated query."""
    tensors = (q, codebooks) if rotation is None else (q, codebooks, rotation)
    if not on_cuda(*tensors):
        return adc_tables_ref(rotate(q, rotation), codebooks)
    q_rot = rotate(q, rotation).contiguous()
    require(q_rot, "q", torch.float32, 2)
    require(codebooks, "codebooks", torch.float32, 3)
    nsub, K, dsub = codebooks.shape
    if q_rot.shape[1] != nsub * dsub:
        raise ValueError(f"q has dim {q_rot.shape[1]}, codebooks cover "
                         f"{nsub}x{dsub}")
    out = torch.empty((q_rot.shape[0], nsub, K), dtype=torch.float32,
                      device=q_rot.device)
    with torch.cuda.device(q_rot.device):
        kernel.adc_tables_cuda(q_rot, codebooks, out)
    record_launch("adc_tables")
    return out


def adc_score_blocks(lut, code_blocks, sel_ids):
    """lut: (B, nsub, K) float32; code_blocks: (U, cap, nsub) uint8;
    sel_ids: (B, S) int32 positions into code_blocks, 0 <= sel < U.
    Returns (B, S, cap) float32 ADC scores."""
    B, S = sel_ids.shape[0], sel_ids.shape[1]
    cap = code_blocks.shape[1]
    if S == 0 or cap == 0 or code_blocks.shape[0] == 0:
        # empty fetch/selection: nothing to score; keep the contract shape
        return torch.zeros((B, S, cap), dtype=torch.float32, device=lut.device)
    if not on_cuda(lut, code_blocks, sel_ids):
        return adc_score_blocks_ref(lut, code_blocks, sel_ids)
    require(lut, "lut", torch.float32, 3)
    require(code_blocks, "code_blocks", torch.uint8, 3)
    require(sel_ids, "sel_ids", torch.int32, 2)
    nsub, K = lut.shape[1], lut.shape[2]
    if lut.shape[0] != B or code_blocks.shape[2] != nsub:
        raise ValueError(f"shape mismatch: lut {tuple(lut.shape)}, "
                         f"code_blocks {tuple(code_blocks.shape)}, "
                         f"sel_ids {tuple(sel_ids.shape)}")
    smem = kernel.score_smem_bytes(cap, nsub, K)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"LUT + code block need {smem} bytes of shared "
                         f"memory, over the {MAX_SMEM_BYTES} a block has")
    out = torch.empty((B, S, cap), dtype=torch.float32, device=lut.device)
    with torch.cuda.device(lut.device):
        kernel.adc_score_blocks_cuda(lut, code_blocks, sel_ids, out)
    record_launch("adc_score_blocks")
    return out
