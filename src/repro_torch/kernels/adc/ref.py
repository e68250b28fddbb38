"""Plain PyTorch versions of the ADC kernels (the CPU path, and what the
CUDA kernels are held to).

Accumulation-order contract (shared with the CUDA kernels and with the
JAX package's Pallas kernels): a block score is

    score[b, s, c] = sum_{j=0}^{nsub-1} lut[b, j, codes[sel[b, s], c, j]]

accumulated in ascending subspace order j with one float32 accumulator,
and each LUT entry is the dsub-long dot q_rot[b, j*dsub:(j+1)*dsub] .
codebooks[j, k], also summed in ascending order. Both loops below add
one slice at a time, so the order is the contract's, not a reduction's.
"""

import torch


def rotate(q, rotation=None):
    """The OPQ rotation, folded in once per query before the LUT build."""
    q = q.float()
    if rotation is not None:
        q = q @ rotation.float()
    return q


def adc_tables_ref(q_rot, codebooks):
    """q_rot: (B, dim) float32, already rotated; codebooks (nsub, K, dsub).
    Returns the (B, nsub, K) float32 lookup tables."""
    nsub, K, dsub = codebooks.shape
    qs = q_rot.float().reshape(q_rot.shape[0], nsub, 1, dsub)
    books = codebooks.float()[None]                    # (1, nsub, K, dsub)
    acc = qs[..., 0] * books[..., 0]
    for d in range(1, dsub):
        acc = acc + qs[..., d] * books[..., d]
    return acc


def adc_score_blocks_ref(lut, code_blocks, sel_ids):
    """lut: (B, nsub, K) float32; code_blocks: (U, cap, nsub) uint8;
    sel_ids: (B, S) int. Returns (B, S, cap) float32."""
    B, nsub, K = lut.shape
    S = sel_ids.shape[1]
    cap = code_blocks.shape[1]
    codes = code_blocks[sel_ids.long()]                # (B, S, cap, nsub)
    acc = torch.zeros((B, S * cap), dtype=torch.float32, device=lut.device)
    for j in range(nsub):
        idx = codes[..., j].reshape(B, S * cap).long()
        acc = acc + lut[:, j, :].float().gather(1, idx)
    return acc.reshape(B, S, cap)
