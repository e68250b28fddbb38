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

Elastic restore: a tree sharded over a mesh (`models.sharding`) is saved
with its `shardings`: every rank takes part in gathering each leaf and
rank 0 writes the whole arrays, so the files keep the one-device layout.
`restore_checkpoint(..., shardings=)` gives each rank its slice of each
leaf under the placements of any other mesh.
"""

import json
import os
import shutil
import struct
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed

from repro_torch.common.tree import leaf_paths, tree_unflatten_like

_SHARD_BYTES = 256 * 1024 * 1024
_IO_THREADS = 8          # shard files written or read at once


def leaf_key(name):
    """jax.tree_util.keystr of a flat dict's key: "['name']"."""
    return f"[{name!r}]"


def _host_copy(x):
    """A numpy copy of a leaf, owning its memory."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


def save_checkpoint(ckpt_dir, step, tree, *, async_save=False, extra=None,
                    shardings=None):
    """Write `tree` under <ckpt_dir>/step_<step>, staged in
    step_<step>.tmp and committed by rename. With `async_save` the write
    runs on a thread, which is returned (join it); else returns None.

    With `shardings` (a tree of NamedShardings of tree's structure),
    `tree` holds this rank's slices: every rank of the mesh calls this,
    each leaf is gathered whole, rank 0 of the mesh writes, and every rank
    returns None once the files are committed."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if shardings is not None:
        leaves = leaf_paths(tree)
        sh_leaves = [s for _, s in leaf_paths(shardings)]
        writer = sh_leaves[0].mesh.rank == 0 if sh_leaves else True
        host = []
        for (p, x), s in zip(leaves, sh_leaves):
            whole = s.gather(x)
            if writer:
                host.append((p, _host_copy(whole)))
            del whole
    else:
        # copy to the host before a possible handoff, so the caller may
        # update the tensors in place as soon as this returns
        host = [(p, _host_copy(x)) for p, x in leaf_paths(tree)]

    def _write():
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": int(step), "leaves": [], "extra": extra or {}}
        shards = [{}]
        shard_bytes = 0
        for i, (path, arr) in enumerate(host):
            key = f"leaf_{i}"
            manifest["leaves"].append({
                "path": path, "key": key, "shard": len(shards) - 1,
                "shape": list(arr.shape), "dtype": str(arr.dtype)})
            shards[-1][key] = arr
            shard_bytes += arr.nbytes
            if shard_bytes >= _SHARD_BYTES:
                shards.append({})
                shard_bytes = 0
        # each shard is its own file, so they are written at once (the
        # zip CRC and the file writes release the GIL)
        with ThreadPoolExecutor(_IO_THREADS) as pool:
            for f in [pool.submit(np.savez, os.path.join(
                    tmp, f"shard_{i}.npz"), **shard)
                    for i, shard in enumerate(shards) if shard]:
                f.result()
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        open(os.path.join(tmp, ".complete"), "w").close()
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if shardings is not None:
        # written before any rank returns, so each may restore at once
        if writer:
            _write()
        mesh = sh_leaves[0].mesh if sh_leaves else None
        if mesh is not None and mesh.size > 1:
            torch.distributed.barrier()
        return None
    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _npz_memmaps(path):
    """{member name: read-only np.memmap of its array} of an npz whose
    members are stored uncompressed (np.savez): each array's bytes lie
    contiguous in the zip file, after its local header and .npy header."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {info.filename} is compressed")
            f.seek(info.header_offset)
            head = f.read(30)
            if head[:4] != b"PK\x03\x04":
                raise ValueError(f"{path}: no local header for "
                                 f"{info.filename}")
            name_len, extra_len = struct.unpack("<HH", head[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                           (2, 0): np.lib.format.read_array_header_2_0}[
                np.lib.format.read_magic(f)]
            shape, fortran, dtype = read_header(f)
            name = info.filename[:-len(".npy")]
            if not int(np.prod(shape)):
                out[name] = np.empty(shape, dtype)
                continue
            out[name] = np.memmap(path, dtype=dtype, mode="r",
                                  offset=f.tell(), shape=shape,
                                  order="F" if fortran else "C")
    return out


def read_checkpoint(ckpt_dir, step, *, mmap=False):
    """({leaf path: array}, extra) of <ckpt_dir>/step_<step>; with `mmap`
    each array is a read-only np.memmap into its shard file, so a reader
    that takes a slice reads only the slice's pages."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_shard = {}
    for leaf in manifest["leaves"]:
        by_shard.setdefault(leaf["shard"], []).append(leaf)

    def load(shard_id, leaves):
        path = os.path.join(d, f"shard_{shard_id}.npz")
        if mmap:
            z = _npz_memmaps(path)
            return {leaf["path"]: z[leaf["key"]] for leaf in leaves}
        with np.load(path) as z:
            return {leaf["path"]: z[leaf["key"]] for leaf in leaves}
    arrays = {}
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        for f in [pool.submit(load, *kv) for kv in by_shard.items()]:
            arrays.update(f.result())
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


def _like(arr, ref, device=None):
    """`arr` cast to the target leaf's dtype: a tensor on `device` (else
    the target's) for a tensor target, else a numpy array."""
    if isinstance(ref, torch.Tensor):
        dev = ref.device if device is None else torch.device(device)
        if dev.type == "meta":
            raise ValueError("a meta target leaf needs a device")
        return torch.from_numpy(np.array(arr)).to(device=dev,
                                                   dtype=ref.dtype)
    if hasattr(ref, "dtype"):
        return np.asarray(arr).astype(ref.dtype)
    return arr


def restore_checkpoint(ckpt_dir, step, target_tree, shardings=None, *,
                       device=None):
    """(tree of `target_tree`'s structure, extra): each leaf read by its
    path and cast to the target leaf's dtype (and device: `device`, else
    the target leaf's; meta targets, as `abstract_params` gives, need
    `device`); a leaf the checkpoint lacks raises KeyError.

    Elastic: with `shardings` (a tree of NamedShardings of the target's
    structure, on any mesh) each leaf is this rank's slice of the saved
    whole array under its sharding, read through a memory map of the
    shard files (only the slice's pages)."""
    arrays, extra = read_checkpoint(ckpt_dir, step,
                                    mmap=shardings is not None)
    sh_flat = [None] * len(leaf_paths(target_tree)) if shardings is None \
        else [s for _, s in leaf_paths(shardings)]
    out = []
    for (key, ref), sh in zip(leaf_paths(target_tree), sh_flat):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key] if sh is None else sh.shard(arrays[key])
        out.append(_like(arr, ref, device))
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
