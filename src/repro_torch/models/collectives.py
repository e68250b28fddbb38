"""Collectives over the axes of a `launch.mesh.Mesh`, each an autograd
Function whose backward is its transpose:

  all_gather        <-> reduce_scatter   (FSDP weights, a layer's nodes)
  reduce_scatter    <-> all_gather
  copy_to           identity <-> all_reduce   (entering a sharded region)
  all_reduce        all_reduce <-> identity   (leaving it: partial sums)
  pmean             mean <-> cotangent / n
  gather_replicated all_gather <-> this rank's slice (leaving it into
                    code that every rank runs alike)

The convention is the one of Megatron's tensor parallelism: a value that
every rank of an axis holds alike is one copy, so its cotangent is not
summed over that axis again; a partial result is summed by all_reduce.

A gloo group carries CUDA tensors through pinned host memory (NCCL
refuses two ranks on one card); bfloat16 and float16 sums are taken in
float32 on the host. Over an axis of size 1 each is the identity; over a
larger one without a process group each raises. `TRAFFIC` counts the
bytes this rank's collectives returned, by kind.
"""

import torch
import torch.distributed as dist

TRAFFIC = {"all_gather": 0, "all_reduce": 0, "reduce_scatter": 0}


def reset_traffic():
    for k in TRAFFIC:
        TRAFFIC[k] = 0


def _group(mesh, axes):
    n = mesh.axis_size(axes)
    if n == 1:
        return None, 1
    if not dist.is_initialized():
        raise RuntimeError(f"a collective over {axes} ({n} ranks) needs an "
                           f"initialized torch.distributed process group")
    return mesh.group(axes), n


def _staged(t, group):
    """(t or its pinned host copy, whether it was staged)."""
    if t.device.type == "cuda" and \
            dist.get_backend(group) == dist.Backend.GLOO:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host, True
    return t, False


def all_gather_group(t, group):
    """[t of every rank of `group`], in group rank order (no gradient);
    16-bit floats travel as bytes (gloo gathers no 16-bit type)."""
    n = dist.get_world_size(group)
    src, staged = _staged(t.contiguous(), group)
    if src.dtype in (torch.bfloat16, torch.float16):
        src = src.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    parts = [p.view(t.dtype).view(t.shape) for p in parts]
    if staged:
        parts = [p.to(t.device, non_blocking=True) for p in parts]
    TRAFFIC["all_gather"] += t.numel() * t.element_size() * n
    return parts


def _parts(t, mesh, axes):
    """Every rank's `t` along `axes`, ordered by axis_index (raw)."""
    group, n = _group(mesh, axes)
    if n == 1:
        return [t]
    parts = all_gather_group(t, group)
    members = mesh.members(axes)
    by_rank = {g: i for i, g in enumerate(sorted(members))}
    return [parts[by_rank[g]] for g in members]


def gather_parts(t, mesh, axes, dim=0):
    """The ranks' `t` along `axes` concatenated on `dim` (raw)."""
    parts = _parts(t, mesh, axes)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def _reduce(t, mesh, axes, op=dist.ReduceOp.SUM):
    """all_reduce of `t` along `axes` into a new tensor (raw)."""
    group, n = _group(mesh, axes)
    if n == 1:
        return t.clone()
    src, staged = _staged(t.contiguous(), group)
    low = src.dtype in (torch.bfloat16, torch.float16) and (
        staged or dist.get_backend(group) == dist.Backend.GLOO)
    buf = src.float() if low else (src if staged else src.clone())
    dist.all_reduce(buf, op=op, group=group)
    out = buf.to(t.dtype) if low else buf
    TRAFFIC["all_reduce"] += t.numel() * t.element_size()
    return out.to(t.device, non_blocking=True) if staged else out


def _slice(t, mesh, axes, dim):
    n = mesh.axis_size(axes)
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over {n} ranks of {axes}")
    k = t.shape[dim] // n
    return t.narrow(dim, mesh.axis_index(axes) * k, k)


def _reduce_scatter(t, mesh, axes, dim):
    """Sum over `axes`, this rank's slice of `dim` (raw): one
    reduce_scatter (`_reduce_scatter_tensor`) on a backend other than
    gloo (NCCL, and the dry run's fake group) where the group's ranks run
    in axis_index order; else an all_reduce and a slice (the card's gloo
    groups carry CUDA tensors through host memory)."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    if dist.get_backend(mesh.group(axes)) != dist.Backend.GLOO and \
            mesh.members(axes) == sorted(mesh.members(axes)):
        return _reduce_scatter_tensor(t, mesh, axes, dim)
    out = _slice(_reduce(t, mesh, axes), mesh, axes, dim).contiguous()
    TRAFFIC["all_reduce"] -= t.numel() * t.element_size()
    TRAFFIC["reduce_scatter"] += t.numel() * t.element_size()
    return out


def _reduce_scatter_tensor(t, mesh, axes, dim):
    """_reduce_scatter by one dist.reduce_scatter_tensor, whose chunk i of
    dim 0 goes to the group's rank i: this rank's slice when the group's
    members (ascending global ranks) run in axis_index order. The CPU
    tests hold it to the all_reduce and slice on gloo."""
    n = mesh.axis_size(axes)
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over {n} ranks of {axes}")
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, x, group=mesh.group(axes))
    TRAFFIC["reduce_scatter"] += t.numel() * t.element_size()
    return out.movedim(0, dim)


def all_reduce_max(t, mesh, axes):
    """Elementwise max over `axes` (no gradient)."""
    return _reduce(t.detach(), mesh, axes, dist.ReduceOp.MAX)


def all_reduce_many(tensors, mesh, axes):
    """Sums over `axes` of several tensors of one dtype in one collective
    (no gradient)."""
    if mesh.axis_size(axes) == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    flat = _reduce(flat, mesh, axes)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return gather_parts(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, ct):
        return _reduce_scatter(ct, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _reduce_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, ct):
        return gather_parts(ct, *ctx.args), None, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _reduce(ct, *ctx.args), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.n = mesh.axis_size(axes)
        return _reduce(x, mesh, axes) / ctx.n

    @staticmethod
    def backward(ctx, ct):
        return ct / ctx.n, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return gather_parts(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, ct):
        return _slice(ct, *ctx.args).contiguous(), None, None, None


def _trivial(mesh, axes):
    axes = () if axes is None else axes
    return mesh is None or not axes or mesh.axis_size(axes) == 1


def all_gather(x, mesh, axes, dim=0):
    """The ranks' x along `axes` concatenated on `dim`; backward: the
    cotangent summed over `axes`, this rank's slice."""
    return x if _trivial(mesh, axes) else _AllGather.apply(x, mesh, axes,
                                                           dim)


def reduce_scatter(x, mesh, axes, dim=0):
    """x summed over `axes`, this rank's slice of `dim`; backward: the
    cotangents all-gathered."""
    return x if _trivial(mesh, axes) else _ReduceScatter.apply(x, mesh,
                                                               axes, dim)


def copy_to(x, mesh, axes):
    """Identity; backward: the cotangent summed over `axes`."""
    return x if _trivial(mesh, axes) else _Copy.apply(x, mesh, axes)


def all_reduce(x, mesh, axes):
    """x summed over `axes`; backward: the identity."""
    return x if _trivial(mesh, axes) else _AllReduce.apply(x, mesh, axes)


def pmean(x, mesh, axes):
    """x's mean over `axes`; backward: the cotangent over their size."""
    return x if _trivial(mesh, axes) else _PMean.apply(x, mesh, axes)


def gather_replicated(x, mesh, axes, dim=0):
    """The ranks' x along `axes` concatenated on `dim`, for code every
    rank runs alike; backward: this rank's slice of the cotangent."""
    return x if _trivial(mesh, axes) else _GatherReplicated.apply(
        x, mesh, axes, dim)
