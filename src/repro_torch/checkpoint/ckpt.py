"""The JAX package's npz checkpoint layout (`repro.checkpoint`), with
numpy and threads only:

  <dir>/step_<N>/manifest.json   # {"step", "leaves": [{path, key, shard,
                                 #   shape, dtype}], "extra"}
  <dir>/step_<N>/shard_<i>.npz   # leaf arrays, ~256 MB per shard
  <dir>/step_<N>/.complete       # commit marker (written before the rename)

A tree is a nested dict whose leaves are tensors, numpy arrays or
scalars (repro_torch.common.tree). A leaf's `path` is jax's `keystr` of
its dict keys, e.g. "['opt']['mu']['b']", and leaves are written in
JAX's flatten order (sorted keys at every level), so the manifest.json
of a tree is byte for byte the JAX writer's, and its npz members hold
the same .npy bytes (the zip headers carry the write time). Either
package restores the other's checkpoints.

Every leaf is copied to the host before `save_checkpoint` returns, also
when the write itself runs on a thread: an optimizer that updates the
params in place after `save` cannot change what is written.
"""

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.common.tree import leaf_paths, tree_unflatten_like

_SHARD_BYTES = 256 * 1024 * 1024


def leaf_key(name):
    """jax.tree_util.keystr of a flat dict's key: "['name']"."""
    return f"[{name!r}]"


def _host_copy(x):
    """A numpy copy of a leaf, owning its memory."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


def save_checkpoint(ckpt_dir, step, tree, *, async_save=False, extra=None):
    """Write `tree` under <ckpt_dir>/step_<step>, staged in
    step_<step>.tmp and committed by rename. With `async_save` the write
    runs on a thread, which is returned (join it); else returns None."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    # copy to the host before a possible handoff, so the caller may
    # update the tensors in place as soon as this returns
    host = [(p, _host_copy(x)) for p, x in leaf_paths(tree)]

    def _write():
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": int(step), "leaves": [], "extra": extra or {}}
        shard, shard_bytes, shard_id = {}, 0, 0

        def flush():
            nonlocal shard, shard_bytes, shard_id
            if shard:
                np.savez(os.path.join(tmp, f"shard_{shard_id}.npz"), **shard)
                shard, shard_bytes = {}, 0
                shard_id += 1

        for i, (path, arr) in enumerate(host):
            key = f"leaf_{i}"
            manifest["leaves"].append({
                "path": path, "key": key, "shard": shard_id,
                "shape": list(arr.shape), "dtype": str(arr.dtype)})
            shard[key] = arr
            shard_bytes += arr.nbytes
            if shard_bytes >= _SHARD_BYTES:
                flush()
        flush()
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        open(os.path.join(tmp, ".complete"), "w").close()
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def read_checkpoint(ckpt_dir, step):
    """({leaf path: array}, extra) of <ckpt_dir>/step_<step>."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_shard = {}
    for leaf in manifest["leaves"]:
        by_shard.setdefault(leaf["shard"], []).append(leaf)
    arrays = {}
    for shard_id, leaves in by_shard.items():
        with np.load(os.path.join(d, f"shard_{shard_id}.npz")) as z:
            for leaf in leaves:
                arrays[leaf["path"]] = z[leaf["key"]]
    return arrays, manifest.get("extra", {})


def latest_step(ckpt_dir):
    """The largest committed step under `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, ".complete")):
                steps.append(int(d.split("_", 1)[1]))
    return max(steps) if steps else None


def _like(arr, ref):
    """`arr` cast to the target leaf's dtype: a tensor on the target's
    device for a tensor target, else a numpy array."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=ref.device,
                                                   dtype=ref.dtype)
    if hasattr(ref, "dtype"):
        return np.asarray(arr).astype(ref.dtype)
    return arr


def restore_checkpoint(ckpt_dir, step, target_tree):
    """(tree of `target_tree`'s structure, extra): each leaf read by its
    path and cast to the target leaf's dtype (and device); a leaf the
    checkpoint lacks raises KeyError."""
    arrays, extra = read_checkpoint(ckpt_dir, step)
    out = []
    for key, ref in leaf_paths(target_tree):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        out.append(_like(arrays[key], ref))
    return tree_unflatten_like(target_tree, out), extra


class CheckpointManager:
    """Keeps at most `keep` checkpoints; async save with join-on-next-save."""

    def __init__(self, ckpt_dir, keep=3, async_save=True):
        self.dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self._pending = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(self, step, tree, extra=None):
        if self._pending is not None:
            self._pending.join()
        self._gc()  # previous save is committed now
        self._pending = save_checkpoint(
            self.dir, step, tree, async_save=self.async_save, extra=extra)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        self._gc()

    def _gc(self):
        steps = sorted(
            int(d.split("_", 1)[1]) for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp")
            and os.path.exists(os.path.join(self.dir, d, ".complete")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def restore_latest(self, target_tree):
        """(step, tree, extra) of the latest checkpoint, or (None, None,
        None) when there is none."""
        self.wait()
        step = latest_step(self.dir)
        if step is None:
            return None, None, None
        tree, extra = restore_checkpoint(self.dir, step, target_tree)
        return step, tree, extra
