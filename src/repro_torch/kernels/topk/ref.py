"""Plain PyTorch row-wise top-k under `jax.lax.top_k`'s rule (the CPU
path, and what the CUDA kernel is held to).

`lax.top_k` orders floats totally: ties are exact bit equality and -0.0
ranks below +0.0. Comparing the floats themselves would make the zeros
equal, so the rows are compared as order-preserving int32 keys (the
sign bit flips the other 31 bits of a negative float). torch.topk finds
the k-th key exactly; every key above it is in, and of the keys equal
to it the lowest-indexed fill the rest; a stable sort of those k then
orders them (key desc, index asc). NaN is out of contract.
"""

import torch


def order_keys(x):
    """int32 keys of float32 x whose order is lax.top_k's order of x."""
    bits = x.float().contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def topk_ref(x, k):
    """The k largest entries of each row of x (..., D), ordered (value
    desc, index asc). Returns (values float32, indices int64)."""
    D = x.shape[-1]
    if not 0 <= k <= D:
        raise ValueError(f"k={k} out of range for rows of length {D}")
    if k == 0:
        return (x[..., :0].float(),
                torch.zeros(x.shape[:-1] + (0,), dtype=torch.long,
                            device=x.device))
    keys = order_keys(x)
    kth = torch.topk(keys, k, dim=-1, sorted=True).values[..., -1:]
    above = keys > kth
    tied = keys == kth
    room = k - above.sum(-1, keepdim=True, dtype=torch.int32)
    keep = above | (tied & (torch.cumsum(tied, -1, dtype=torch.int32) <= room))
    # exactly k entries per row are kept; nonzero lists them row-major,
    # so each row's indices come out ascending
    idx = keep.reshape(-1, D).nonzero()[:, 1].reshape(x.shape[:-1] + (k,))
    order = torch.sort(keys.gather(-1, idx), dim=-1, descending=True,
                       stable=True).indices
    idx = idx.gather(-1, order)
    return x.float().gather(-1, idx), idx
