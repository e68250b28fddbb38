"""The JAX package's npz checkpoint layout, with numpy only:

  <dir>/step_<N>/manifest.json   # {"step", "leaves": [{path, key, shard,
                                 #   shape, dtype}], "extra"}
  <dir>/step_<N>/shard_<i>.npz   # leaf arrays, ~256 MB per shard
  <dir>/step_<N>/.complete       # commit marker (written before the rename)

A leaf's `path` is jax's `keystr` of its tree path; for a flat dict of
arrays that is "['<name>']", and jax orders the leaves by sorted key.
`save_checkpoint` writes a flat dict in that order, so its manifest.json
is byte for byte the JAX writer's, and its npz members hold the same
.npy bytes (the zip headers carry the write time).
"""

import json
import os
import shutil

import numpy as np

_SHARD_BYTES = 256 * 1024 * 1024


def leaf_key(name):
    """jax.tree_util.keystr of a flat dict's key: "['name']"."""
    return f"[{name!r}]"


def save_checkpoint(ckpt_dir, step, arrays, *, extra=None):
    """Write the flat dict `arrays` ({name: array}) under
    <ckpt_dir>/step_<step>, staged in step_<step>.tmp and committed by
    rename."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    host = [(leaf_key(k), np.asarray(arrays[k])) for k in sorted(arrays)]
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
