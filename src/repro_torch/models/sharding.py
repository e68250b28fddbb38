"""Logical-axis sharding: the JAX package's `repro.models.sharding` over
the port's `launch.mesh.Mesh`.

Models name each tensor dimension with a logical axis ("batch", "heads",
"embed_w", ...); the launcher installs a rules table mapping logical
names to mesh axes. A PartitionSpec is a plain tuple here, one entry per
dimension: None (replicated), a mesh axis name, or a tuple of them (the
dimension split over their product, the first axis major).

`named_sharding(mesh, *names)` gives a NamedSharding: the mesh and that
tuple, with `shard(t)` (this rank's slice of a global tensor) and
`gather(t)` (the global tensor back from every rank's slice). As
`jax.device_put` does, a dimension that does not divide by its axes'
size raises.
"""

import contextlib
import dataclasses
import threading

_state = threading.local()


# Default rules for the production (data, model) mesh; the multi-pod mesh
# prepends a pure-DP "pod" axis to every "batch"-like logical axis.
BASE_RULES = {
    # activations
    "batch": ("data",),
    "seq": None,
    "seq_kv": None,           # decode KV-sequence axis
    "embed": None,
    "heads": ("model",),
    "kv_heads": None,
    "head_dim": None,
    "ff_act": ("model",),
    # weights
    "vocab": ("model",),
    "embed_w": ("data",),     # FSDP row shard
    "ff_w": ("model",),
    "heads_w": ("model",),
    "experts": ("model",),
    "layers": None,
    # gnn / recsys
    "edges": ("data", "model"),
    "nodes": None,
    "table_rows": ("data", "model"),
    "candidates": ("model",),
    # retrieval (CluSD)
    "docs": ("model",),
    "clusters": ("model",),
    "queries": ("data",),
}


def install_rules(rules=None, mesh=None, pod_dp=False):
    """Install rules (dict logical -> mesh-axis tuple or None) and the
    active mesh for this thread; returns the table.

    pod_dp extensions are applied BEFORE per-cell overrides so an override
    like batch=None (unshardable batch-1 decode) always wins.
    """
    table = dict(BASE_RULES)
    if pod_dp:
        for key in ("batch", "queries", "embed_w", "table_rows"):
            cur = table.get(key) or ()
            table[key] = ("pod",) + tuple(cur)
    if rules:
        table.update(rules)
    _state.rules = table
    _state.mesh = mesh
    return table


def current_rules():
    return getattr(_state, "rules", None)


def current_mesh():
    """The mesh installed on this thread, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def rules_ctx(rules=None, mesh=None, pod_dp=False):
    """install_rules for the body; the previous rules and mesh come back
    after it, also when it raises."""
    prev = (getattr(_state, "rules", None), getattr(_state, "mesh", None))
    install_rules(rules, mesh, pod_dp)
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev


def spec(*names):
    """The PartitionSpec (a tuple, one entry per name) of logical axis
    names under the installed rules (BASE_RULES when none are): None, an
    axis name, or a tuple of two or more axis names."""
    rules = current_rules() or BASE_RULES
    parts = []
    for nm in names:
        ax = None if nm is None else rules.get(nm)
        if ax is None:
            parts.append(None)
        elif isinstance(ax, (tuple, list)):
            parts.append(tuple(ax) if len(ax) > 1 else ax[0])
        else:
            parts.append(ax)
    return tuple(parts)


def spec_axes(entry):
    """The mesh axes of one spec entry, as a tuple (() for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement over a mesh: dimension i is split over the mesh axes of
    spec[i] (none: every rank holds all of it)."""
    mesh: object
    spec: tuple

    def _check(self, ndim):
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"tensor's {ndim} dimensions")
        for e in self.spec:
            for a in spec_axes(e):
                if a not in self.mesh.shape:
                    raise ValueError(f"axis {a!r} of spec {self.spec} is "
                                     f"not in the mesh {self.mesh.shape}")

    def parts(self, dim):
        """How many slices dimension `dim` is cut into."""
        if dim >= len(self.spec):
            return 1
        return self.mesh.axis_size(spec_axes(self.spec[dim]))

    def local_shape(self, global_shape):
        """This rank's slice's shape; a dimension that does not divide by
        its axes' size raises ValueError, as jax.device_put does."""
        self._check(len(global_shape))
        out = []
        for i, n in enumerate(global_shape):
            p = self.parts(i)
            if n % p:
                raise ValueError(
                    f"sharding {self.spec} implies that dimension {i} of "
                    f"{tuple(global_shape)} divides by {p}, but it is {n}")
            out.append(n // p)
        return tuple(out)

    def shard(self, t):
        """This rank's slice of the global tensor (or numpy array) `t`: a
        view where the layout allows."""
        self.local_shape(tuple(t.shape))
        for i, e in enumerate(self.spec):
            axes = spec_axes(e)
            if not axes:
                continue
            n = t.shape[i] // self.mesh.axis_size(axes)
            lo = self.mesh.axis_index(axes) * n
            t = t[(slice(None),) * i + (slice(lo, lo + n),)]
        return t

    def gather(self, t):
        """The global tensor from every rank's slice `t` (a collective over
        the mesh axes of the spec; every rank of the mesh calls it)."""
        from repro_torch.models import collectives as coll
        self._check(t.dim())
        for i, e in enumerate(self.spec):
            axes = spec_axes(e)
            if axes:
                t = coll.gather_parts(t, self.mesh, axes, i)
        return t

    def sharded_axes(self):
        """The mesh axes (of size > 1) that some dimension is split over."""
        return tuple(a for a in self.mesh.axis_names
                     if self.mesh.shape[a] > 1
                     and any(a in spec_axes(e) for e in self.spec))


def named_sharding(mesh, *names):
    return NamedSharding(mesh, spec(*names))


def logical(x, *names, shape=None):
    """The sharding annotation by logical names: a no-op without a mesh,
    as in the reference. With a mesh it checks that `x`, this rank's
    slice, has one name per dimension and, when the global `shape` is
    given, the local shape the spec implies; it raises ValueError if not
    and never reshards."""
    mesh = current_mesh()
    if mesh is None:
        return x
    if len(names) != x.dim():
        raise ValueError(f"{len(names)} logical names {names} for a "
                         f"{x.dim()}-d tensor")
    if shape is not None:
        want = named_sharding(mesh, *names).local_shape(tuple(shape))
        if tuple(x.shape) != want:
            raise ValueError(f"{names}: local shape {tuple(x.shape)}, the "
                             f"spec {spec(*names)} of global {tuple(shape)} "
                             f"implies {want}")
    return x


def shard_tree(tree, shardings):
    """Each leaf's slice on this rank (a tree of tree's structure)."""
    from repro_torch.common import tree as tu
    return tu.tree_map(lambda x, s: s.shard(x), tree, shardings)


def gather_tree(tree, shardings):
    """Each leaf's global tensor from the ranks' slices (a collective)."""
    from repro_torch.common import tree as tu
    return tu.tree_map(lambda x, s: s.gather(x), tree, shardings)
