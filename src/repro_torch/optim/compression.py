"""Int8 error-feedback gradient compression for data-parallel gradient
all-reduce: the JAX package's `repro.optim.compression`, over a
`torch.distributed` process group in place of a mesh axis.

Scheme: EF21-style — quantize (g + error_carry) to int8 with a scale
common to every rank, gather the int8 payload, sum it exactly in int32,
dequantize, and carry the quantization residual to the next step.
Convergence-safe: the residual is re-injected, so the compressor is
contractive.
"""

import torch
import torch.distributed as dist

from repro_torch.common import tree as tu
from repro_torch.core.distributed import all_gather_rank_major


def ef_init(params):
    """A float32 zero error carry shaped like `params`."""
    return tu.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


def _quantize(x, n_shards):
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / (scale * n_shards)), -127, 127) \
        .to(torch.int8)
    return q, scale


def compressed_psum(grads, error, group=None, n_shards=None):
    """All-reduce int8-quantized (grad + error) over the ranks of `group`
    (None: the default group). Returns (the dequantized SUM over the
    ranks, float32; the new error carry), as the reference returns it —
    its docstring says mean, its arithmetic sums (ROADMAP queue C).

    The scale is common to all ranks (an all_reduce MAX of each rank's
    max |g32|), the int8 tensors travel by all_gather in rank order
    (through host memory on gloo) and are summed in int32, which is
    exact, so every rank gets the same bits. `n_shards` is the group's
    size; it is checked, as the reference's scale does not use it."""
    n = dist.get_world_size(group)
    if n_shards is not None and n_shards != n:
        raise ValueError(f"n_shards={n_shards}, the group has {n} ranks")

    def one(g, e):
        g32 = g.float() + e
        amax = torch.max(torch.abs(g32))
        if amax.device.type == "cuda" and \
                dist.get_backend(group) == dist.Backend.GLOO:
            host = amax.cpu()
            dist.all_reduce(host, op=dist.ReduceOp.MAX, group=group)
            amax = host.to(g32.device)
        else:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = amax / 127.0 + 1e-12
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        qs = all_gather_rank_major(q, group)              # (n, ...) int8
        deq = torch.sum(qs.to(torch.int32), dim=0).float() * scale
        return deq, g32 - q.float() * scale               # error feedback

    out = [one(g, e) for g, e in zip(tu.tree_leaves(grads),
                                      tu.tree_leaves(error))]
    return (tu.tree_unflatten_like(grads, [o[0] for o in out]),
            tu.tree_unflatten_like(grads, [o[1] for o in out]))


def compress_roundtrip(g, e):
    """Single-process building block (tested without a group): returns
    (dequantized, new_error) for one tensor."""
    g32 = g.float() + e
    q, scale = _quantize(g32, 1)
    deq = q.float() * scale
    return deq, g32 - deq
