"""Plain PyTorch selected-cluster scoring (the CPU path, and what the CUDA
kernel is held to). It materialises the (B, S, cap, dim) gather, which
the kernel never does: use it at test sizes and for the check on the
card, not on the serving path there."""

import torch


def cluster_score_ref(q, blocks, sel_ids):
    """q: (B, dim); blocks: (U, cap, dim); sel_ids: (B, S) positions into
    blocks -> (B, S, cap) float32."""
    gathered = blocks[sel_ids.long()]                  # (B, S, cap, dim)
    return torch.einsum("bd,bscd->bsc", q.float(), gathered.float())
