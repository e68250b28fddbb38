"""Public embedding-bag op: out[b] = sum over h of table[idx[b, h]]. CPU
tensors take the plain version (ref.py); CUDA tensors launch the kernel
of csrc/embedding_bag.cu after the checks below, or raise: a failed
build or launch is an error, never a switch to ref. An index outside
[0, V) raises IndexError on either device before the op returns: on
the CPU by a check before the lookup (torch indexing would wrap -1
round), on the card from the call's own error word once its stream
has finished (no extra pass over the indices; concurrent calls on
other threads or streams each keep their own word). Under autograd (a
table that requires grad) the op is `_EmbeddingBagFn`: its forward is
this launch (the plain version on the CPU), its backward the plain VJP,
an index_add_ of each bag's gradient into its rows, which is how JAX
differentiates the `jnp.take` of its recsys lookups; there is no
backward kernel."""

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


class _EmbeddingBagFn(torch.autograd.Function):
    """Forward: the bag op. Backward: d table[idx[b, h]] += g[b] for
    every (b, h), one index_add_ (atomics on the card, so duplicate rows
    add in no fixed order there)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        ctx.table_dtype = table.dtype
        return _bag(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        B, hot = idx.shape
        d = ctx.table_shape[1]
        grad = torch.zeros(ctx.table_shape, dtype=torch.float32,
                           device=g.device)
        rows = g.float()[:, None, :].expand(B, hot, d).reshape(B * hot, d)
        grad.index_add_(0, idx.reshape(-1).long(), rows)
        return grad.to(ctx.table_dtype), None


def embedding_bag(table, idx):
    """table: (V, d) float32 or bfloat16; idx: (B, hot) int32 (any
    integer type on the CPU). Returns the sum-pooled (B, d) bags in the
    table's dtype, each summed in ascending h in float32;
    differentiable in `table`."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbeddingBagFn.apply(table, idx)
    return _bag(table, idx)


def _bag(table, idx):
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
