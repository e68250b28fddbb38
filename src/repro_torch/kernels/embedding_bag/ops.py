"""Public embedding-bag op: out[b] = sum over h of table[idx[b, h]]. CPU
tensors take the plain version (ref.py); CUDA tensors launch the kernel
of csrc/embedding_bag.cu after the checks below, or raise: a failed
build or launch is an error, never a switch to ref. An index outside
[0, V) raises IndexError on either device before the op returns: on
the CPU by a check before the lookup (torch indexing would wrap -1
round), on the card from the call's own error word once its stream
has finished (no extra pass over the indices; concurrent calls on
other threads or streams each keep their own word)."""

import torch

from repro_torch.kernels import on_cuda, record_launch, require
from repro_torch.kernels.embedding_bag import kernel
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref


def _check_range(idx, V):
    """Every index in [0, V) on the CPU: torch indexing wraps -1 round to
    the last row, and a wrong field offset in a fused table would read
    another field's rows."""
    if idx.numel():
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()  # one host sync
        if lo < 0 or hi >= V:
            raise IndexError(f"embedding_bag: indices span [{lo}, {hi}], "
                             f"outside the table's [0, {V})")


def embedding_bag(table, idx):
    """table: (V, d) float32 or bfloat16; idx: (B, hot) int32 (any
    integer type on the CPU). Returns the sum-pooled (B, d) bags in the
    table's dtype, each summed in ascending h in float32."""
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"table must be (V, d) and idx (B, hot), got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if not on_cuda(table, idx):
        _check_range(idx, table.shape[0])
        return embedding_bag_ref(table, idx)
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table must be float32 or bfloat16, got "
                        f"{table.dtype}")
    require(table, "table", table.dtype, 2)
    require(idx, "idx", torch.int32, 2)
    B, d = idx.shape[0], table.shape[1]
    out = torch.empty((B, d), dtype=table.dtype, device=table.device)
    if B == 0 or d == 0:
        return out
    if table.shape[0] == 0 and idx.shape[1]:
        raise IndexError("embedding_bag: every index is outside the "
                         "table's [0, 0)")
    with torch.cuda.device(table.device):
        # the call's own error word, zeroed on its stream; .item() waits
        # for that stream, the op's one host sync
        err = torch.zeros(1, dtype=torch.int64, device=table.device)
        kernel.embedding_bag_cuda(table, idx, out, err)
        record_launch("embedding_bag")
        bad = kernel.bad_index(err.item())
    if bad is not None:
        raise IndexError(f"embedding_bag: index {bad} is outside the "
                         f"table's [0, {table.shape[0]})")
    return out
