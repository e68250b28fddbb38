"""Atomic selector publishing: commit trained weights + calibrated
thresholds into a built index as a new generation, a port of the JAX
package's `repro.train.publish` that writes the same files and the same
manifest.

New artifacts are staged under `<index_dir>/.stage-g<G>` with
generation-suffixed names (`lstm.g<G>/step_0/...`), moved into place
without clobbering anything the live manifest references, the current
manifest is archived to `manifests/manifest.g<g>.json`, and the new
manifest replaces `manifest.json` atomically
(`index.format.commit_generation`). A serving engine adopts the new
selector between batches via `RetrievalEngine.reload_selector()`.

What a publish changes in the manifest: generation / parent_generation,
`lstm` (the new checkpoint), config.theta / config.max_selected (and
optionally expand_depth, fusion), and the `selector` metadata block
(operating point, calibration table, label config, training stats).
Cluster blocks, arrays and postings are carried by reference: a publish
rewrites zero corpus bytes.
"""

import copy
import os
import shutil
import time

from repro_torch.checkpoint import save_checkpoint
from repro_torch.core.fusion import FUSION_METHODS
from repro_torch.index import format as fmt
from repro_torch.index.builder import _np


def _stage_relpaths(stage):
    out = []
    for dirpath, _, names in os.walk(stage):
        for name in sorted(names):
            out.append(os.path.relpath(os.path.join(dirpath, name), stage))
    return sorted(out)


def publish_selector(index_dir, params, *, theta=None, budget=None,
                     calibration=None, label_config=None, train_meta=None,
                     selector="lstm", verify="size", expand_depth=None,
                     fusion=None):
    """Commit `params` (a param dict of tensors or arrays) and the
    calibrated theta/budget to the index at `index_dir` as generation
    G = current + 1. Returns a report dict. `expand_depth` and `fusion`
    ("interp" | "rrf") land in the manifest config as theta/budget do.
    Only the LSTM selector round-trips through the manifest's `lstm`
    checkpoint schema."""
    if selector != "lstm":
        raise ValueError(f"publish supports the lstm selector (manifest "
                         f"schema), got {selector!r}")
    t0 = time.perf_counter()
    manifest = fmt.load_manifest(index_dir)
    fmt.verify_files(index_dir, manifest, level=verify)
    g = fmt.manifest_generation(manifest)
    G = g + 1

    host = {k: _np(v) for k, v in params.items()}
    for key in ("wx", "wh", "b", "head_w", "head_b"):
        if key not in host:
            raise ValueError(f"lstm params missing leaf {key!r}")
    feat_dim = int(host["wx"].shape[0])
    hidden = int(host["wh"].shape[0])

    # -- stage the new checkpoint under a generation-suffixed dir ----------
    stage = os.path.join(index_dir, f".stage-g{G}")
    if os.path.exists(stage):
        shutil.rmtree(stage)
    os.makedirs(stage)
    lstm_dir = f"lstm.g{G}"
    lstm_meta = {"dir": lstm_dir, "step": 0, "selector": selector,
                 "feat_dim": feat_dim, "hidden": hidden}
    save_checkpoint(os.path.join(stage, lstm_dir), 0, host,
                    extra={k: lstm_meta[k]
                           for k in ("selector", "feat_dim", "hidden")})
    staged = _stage_relpaths(stage)

    # -- manifest for generation G -----------------------------------------
    new_manifest = copy.deepcopy(manifest)
    new_manifest["generation"] = G
    new_manifest["parent_generation"] = g
    new_manifest["lstm"] = lstm_meta
    cfg_d = new_manifest["config"]
    if theta is not None:
        cfg_d["theta"] = float(theta)
    if budget is not None:
        cfg_d["max_selected"] = int(budget)
    if expand_depth is not None:
        cfg_d["expand_depth"] = int(expand_depth)
    if fusion is not None:
        if fusion not in FUSION_METHODS:
            raise ValueError(f"fusion must be one of {FUSION_METHODS}, "
                             f"got {fusion!r}")
        cfg_d["fusion"] = str(fusion)
    new_manifest["selector"] = {
        "selector": selector,
        "published_generation": G,
        "theta": cfg_d["theta"],
        "budget": cfg_d["max_selected"],
        "expand_depth": int(cfg_d.get("expand_depth", 0)),
        "fusion": str(cfg_d.get("fusion", "interp")),
        "calibration": list(calibration or []),
        "label_config": dict(label_config or {}),
        "train": dict(train_meta or {}),
    }

    old_lstm = (manifest.get("lstm") or {}).get("dir")
    files = {rel: e for rel, e in manifest["files"].items()
             if not (old_lstm and (rel == old_lstm
                                   or rel.startswith(old_lstm + "/")
                                   or rel.startswith(old_lstm + os.sep)))}
    for rel in staged:
        full = os.path.join(stage, rel)
        files[rel] = {"bytes": os.path.getsize(full),
                      "sha256": fmt.file_sha256(full)}
    new_manifest["files"] = files
    new_manifest["total_bytes"] = sum(e["bytes"] for e in files.values())

    # -- commit: the shared generation protocol (index/format.py) ----------
    fmt.commit_generation(index_dir, stage, staged, manifest, new_manifest)

    return {
        "generation": G,
        "parent_generation": g,
        "lstm_dir": lstm_dir,
        "theta": cfg_d["theta"],
        "budget": cfg_d["max_selected"],
        "n_files_added": len(staged),
        "bytes_added": sum(files[rel]["bytes"] for rel in staged),
        "wall_s": round(time.perf_counter() - t0, 3),
    }
