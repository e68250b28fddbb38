"""The per-rank cost of a step, counted as it runs: the counterpart of
the JAX package's `repro.analysis.hlo` for a port that has no HLO.

The step runs on this rank's tensors (meta tensors in the dry run: no
storage, no arithmetic) under one TorchDispatchMode, `CostMode`, which
sees every aten op and every c10d collective the step dispatches, its
backward included, and counts:

  * FLOPs of the dot-like ops (matmuls, batched matmuls, convolutions,
    attention), by torch.utils.flop_counter's formulas: 2 x output
    elements x the contracted size, as `hlo._dot_flops` counts a dot;
  * HBM bytes: the output plus operand bytes of every op that is not a
    view or an allocation, as `hlo._comp_cost` counts every op that
    materializes. Eager PyTorch runs each aten op as one kernel, so this
    is the eager traffic, not XLA's fused one;
  * collectives by kind ("all-gather", "reduce-scatter", "all-reduce",
    "all-to-all"), per rank, at the c10d ops, by the ring model of
    `hlo._line_collective` with the group size of the op's process
    group: `<kind>_raw` / `<kind>_wire`, "raw", "wire" and "count":

      all-gather      raw = output bytes,  wire = (g-1)/g x raw
      reduce-scatter  raw = input bytes,   wire = (g-1)/g x raw
      all-reduce      raw = bytes,         wire = 2 (g-1)/g x raw
      all-to-all      raw = bytes,         wire = (g-1)/g x raw

  * the peak live bytes of the rank: the arguments' storages plus the
    largest set of other storages alive at once, each tracked from the
    op that made it to its release through a weak reference to its
    storage (tensors autograd keeps for the backward count while kept).

Depth is handled as `hlo`'s trip counts handle it: a layer loop runs
each layer's ops once per layer, so every count is affine in the number
of layers; `extrapolate` takes the counts at two neighbouring depths to
any depth.
"""

import os
import traceback

import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# c10d op -> (kind, which bytes are raw: "out" | "in"): the ops of
# dist.all_reduce, all_gather, all_gather_into_tensor and
# reduce_scatter_tensor, which models/collectives.py calls
_C10D = {
    "allreduce_": ("all-reduce", "in"),
    "allgather_": ("all-gather", "out"),
    "_allgather_base_": ("all-gather", "out"),
    "_reduce_scatter_base_": ("reduce-scatter", "in"),
}
# c10d ops that move no tensor data
_C10D_FREE = {"barrier", "monitored_barrier"}

# ops that move no bytes: allocations and aliases
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_to_copy_meta", "set_", "resize_"}

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
_SKIP_FRAMES = (os.path.join(_PKG, "models", "collectives.py"), _HERE)


def _nbytes(t):
    return t.numel() * t.element_size()


def _tensors(x):
    return [t for t in pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]


def _ring(kind, raw, g):
    ring = (g - 1) / max(g, 1)
    if kind == "all-reduce":
        return 2 * ring * raw
    return ring * raw


def _frame():
    """The innermost frame of this package outside the collectives and
    this analysis, as "models/transformer.py:_layer:412"."""
    stack = traceback.extract_stack()
    best = None
    for fr in reversed(stack):
        f = os.path.abspath(fr.filename)
        if not f.startswith(_PKG):
            continue
        if best is None:
            best = fr
        if not f.startswith(_SKIP_FRAMES):
            best = fr
            break
    if best is None:
        return ""
    rel = os.path.relpath(os.path.abspath(best.filename), _PKG)
    return f"{rel}:{best.name}:{best.lineno}"


class CostMode(TorchDispatchMode):
    """Counts the ops dispatched inside it (see the module docstring).

    args: the step's arguments, whose storages count as the arguments'
    bytes and never as new ones; record_ops keeps one text line per op
    (`ops`); `collective_sites` holds (kind, shape, frame) -> wire bytes
    for every collective."""

    def __init__(self, args=(), record_ops=False):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll = {}
        self.collective_sites = {}
        self.record_ops = record_ops
        self.ops = []
        self.arg_storages = {}
        for t in _tensors(args):
            st = t.untyped_storage()
            self.arg_storages[StorageWeakRef(st).cdata] = st.nbytes()
        self.arg_bytes = sum(self.arg_storages.values())
        self._live = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0

    # -- peak ------------------------------------------------------------
    def _sweep(self):
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self.live_bytes -= self._live.pop(k)[1]

    def _track(self, out):
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            ref = StorageWeakRef(st)
            if ref.cdata in self.arg_storages or ref.cdata in self._live:
                continue
            self._live[ref.cdata] = (ref, st.nbytes())
            self.live_bytes += st.nbytes()
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    # -- counting ---------------------------------------------------------
    def _collective(self, func, args, out):
        kind, which = _C10D[func._overloadpacket.__name__]
        pg = next(a for a in pytree.tree_leaves(args)
                  if isinstance(a, torch.ScriptObject)
                  and "ProcessGroup" in str(a._type()))
        g = dist.ProcessGroup.unbox(pg).size()
        # allreduce_'s first argument is its tensors, the others' their
        # outputs and the second their inputs
        counted = _tensors(args[1] if which == "in" and kind != "all-reduce"
                           else args[0])
        raw = sum(_nbytes(t) for t in counted)
        shapes = [tuple(t.shape) for t in counted][:1]
        wire = _ring(kind, raw, g)
        c = self.coll
        c[f"{kind}_raw"] = c.get(f"{kind}_raw", 0.0) + raw
        c[f"{kind}_wire"] = c.get(f"{kind}_wire", 0.0) + wire
        c["raw"] = c.get("raw", 0.0) + raw
        c["wire"] = c.get("wire", 0.0) + wire
        c["count"] = c.get("count", 0.0) + 1
        key = (kind, f"{shapes[0] if shapes else ()} x{g}", _frame())
        self.collective_sites[key] = self.collective_sites.get(key, 0.0) \
            + wire
        if self.record_ops:
            self.ops.append(f"{kind} group={g} raw={raw} wire={wire:.0f} "
                            f"{shapes} {key[2]}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._sweep()
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if func.namespace == "c10d":
            if name in _C10D:
                self._collective(func, args, out)
            elif name not in _C10D_FREE:
                raise NotImplementedError(
                    f"the cost count has no ring model for c10d.{name}")
            self._track(out)
            return out
        f = 0.0
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            f = float(fn(*args, **kwargs, out_val=out))
            self.flops += f
        b = 0
        if not func.is_view and name not in _NO_TRAFFIC:
            b = sum(_nbytes(t) for t in _tensors((args, kwargs))) + \
                sum(_nbytes(t) for t in _tensors(out))
            self.hbm_bytes += b
        self._track(out)
        if self.record_ops:
            shp = [tuple(t.shape) for t in _tensors(args)][:4]
            self.ops.append(f"{func} {shp} flops={f:.0f} bytes={b}")
        return out

    # -- results ----------------------------------------------------------
    def cost(self):
        """{"flops", "hbm_bytes"} per rank, as hlo.hlo_cost."""
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes}

    def collectives(self):
        """Per-rank collective bytes by kind, as hlo.collective_bytes."""
        return dict(self.coll)

    def peak_bytes(self):
        """The arguments plus the most non-argument bytes alive at once."""
        return self.arg_bytes + self.peak_live_bytes


def count_step(fn, args, record_ops=False):
    """Run fn(*args) under a CostMode; returns (its output, the mode).
    The arguments are released by the caller, so the output and every
    storage the step made is counted against them."""
    mode = CostMode(args, record_ops=record_ops)
    with mode:
        out = fn(*args)
    return out, mode


def extrapolate(at1, at2, n, lo=1):
    """Counts at depth n from counts at depths lo and lo + 1 (dicts of
    numbers, nested dicts alike): at1 + (n - lo) x (at2 - at1)."""
    out = {}
    for k in set(at1) | set(at2):
        a, b = at1.get(k, 0.0), at2.get(k, 0.0)
        if isinstance(a, dict) or isinstance(b, dict):
            out[k] = extrapolate(a or {}, b or {}, n, lo)
        else:
            out[k] = a + (n - lo) * (b - a)
    return out
