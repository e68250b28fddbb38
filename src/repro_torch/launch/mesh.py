"""Named-axis meshes over torch.distributed: the JAX package's
`repro.launch.mesh`.

A Mesh lays the ranks of an initialized process group out row-major over
named axes, as `jax.make_mesh` lays out devices: rank r sits at
`np.unravel_index(r, shape)`. For every set of axes it holds the process
group of this rank's line (or plane) along them, made once for all when
the mesh is built (every rank makes every group, in one order, as
`dist.new_group` requires). An axis of size 1 needs no group.

Importing this module touches no process group. The production meshes
(16 x 16, or 2 x 16 x 16 with a pure data-parallel "pod" axis) need 256
or 512 ranks and raise with fewer; the port builds and validates them,
it runs the debug meshes.
"""

import itertools
import math

import numpy as np
import torch.distributed as dist


def _axes(axes):
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """This rank's place in a grid of ranks with named axes.

    shape: {axis: size} in axis order; coords: {axis: this rank's index};
    axis_size(axes) / axis_index(axes): the size of, and this rank's
    row-major index over, a tuple of axes in the order given;
    group(axes): the process group of the ranks that differ from this
    one only along `axes` (None when they are this rank alone);
    members(axes): their global ranks, ordered by their axis_index."""

    def __init__(self, shape, axes, rank=0, groups=None):
        shape, axes = tuple(int(s) for s in shape), _axes(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes}")
        self.axis_names = axes
        self.devices_shape = shape
        self.shape = dict(zip(axes, shape))
        self.rank = int(rank)
        self.size = math.prod(shape)
        self.coords = dict(zip(axes, (int(c) for c in np.unravel_index(
            self.rank, shape)))) if shape else {}
        self._groups = dict(groups or {})

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"

    def _check(self, axes):
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} is not in the mesh "
                                 f"{self.shape}")

    def axis_size(self, axes):
        axes = _axes(axes)
        self._check(axes)
        return math.prod(self.shape[a] for a in axes)

    def axis_index(self, axes):
        axes = _axes(axes)
        self._check(axes)
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def _key(self, axes):
        """The axes of size > 1 among `axes`, in mesh order."""
        axes = set(_axes(axes))
        self._check(axes)
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def group(self, axes):
        """The process group along `axes`; None if only this rank is on
        it. A mesh built without groups raises for a larger line."""
        key = self._key(axes)
        if not key:
            return None
        if key not in self._groups:
            raise RuntimeError(
                f"the mesh {self.shape} has no process group along {key}: "
                f"a mesh of more than one rank needs an initialized "
                f"torch.distributed process group (make_debug_mesh)")
        return self._groups[key]

    def members(self, axes):
        """Global ranks along `axes` through this rank, by axis_index."""
        axes = _axes(axes)
        self._check(axes)
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(self.coords, **dict(zip(axes, idx)))
            out.append(int(np.ravel_multi_index(
                [c[a] for a in self.axis_names], self.devices_shape)))
        return out


def _new_groups(shape, axes, rank):
    """Every rank makes the group of every line along every set of axes
    of size > 1, in one order; returns this rank's."""
    big = [a for a, s in zip(axes, shape) if s > 1]
    out = {}
    coords = np.indices(shape).reshape(len(shape), -1).T     # rank-major
    for r in range(1, len(big) + 1):
        for key in itertools.combinations(big, r):
            rest = [i for i, a in enumerate(axes) if a not in key]
            lines = {}
            for g, c in enumerate(coords):
                lines.setdefault(tuple(c[rest]), []).append(g)
            for ranks in sorted(lines.values()):
                grp = dist.new_group(ranks)
                if rank in ranks:
                    out[key] = grp
    return out


def make_mesh(shape, axes):
    """The Mesh of this rank over an initialized default process group of
    prod(shape) ranks; a mesh of one rank needs no group."""
    shape, axes = tuple(shape), _axes(axes)
    n = math.prod(shape)
    if n == 1:
        return Mesh(shape, axes)
    if not dist.is_initialized():
        raise RuntimeError("a mesh of more than one rank needs an "
                           "initialized torch.distributed process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"world size {world} != mesh {shape} ({n} ranks)")
    return Mesh(shape, axes, rank, _new_groups(shape, axes, rank))


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 ("data", "model"), or 2 x 16 x 16 ("pod", "data", "model")
    with multi_pod; raises RuntimeError when the process group has fewer
    ranks, as the reference does with fewer devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {have}. Start {n} "
            f"processes in one torch.distributed process group.")
    return make_mesh(shape, axes)


def make_debug_mesh(shape=(2, 2), axes=("data", "model")):
    """A small mesh over the ranks of the default process group (4 gloo
    processes for the CPU tests and on one card)."""
    return make_mesh(shape, axes)
