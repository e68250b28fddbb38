"""Multi-rank dry run: every (architecture x input-shape) cell on the
16 x 16 production mesh and the 2 x 16 x 16 multi-pod mesh, counted on
one rank of a fake process group; the JAX package's
`repro.launch.dryrun`, whose records it keeps the keys of.

No storage is allocated and no device is touched: the process starts
torch.distributed's "fake" backend with 256 or 512 ranks (its
collectives return at once), builds `launch.mesh.make_production_mesh`,
and runs rank 0's step on meta tensors of its slices' shapes
(`NamedSharding.local_shape`) under `analysis.cost.CostMode`. Kernels on
meta tensors take their plain versions, so their counts are the plain
arithmetic's (the record says `"kernels": "plain"`). Depth: the LM and
GNN cells run at two neighbouring depths (1 and 2 layers, NequIP 2 and
3) and are extrapolated to the config's depth (every count is affine in
it).

Each record goes to artifacts/dryrun_torch/<cell>.json: memory per rank
(`fits_hbm_80g` against the H100 SXM's 80 GB), FLOPs and HBM bytes per
rank, collective bytes by kind, the roofline terms against
`common.hw.H100_SXM`, `model_flops`, the rules and the overrides, and
`trace_s` (the seconds the counted steps took on this host).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi|both] [--force] [--rules k=v,...] [--tag T]
"""

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.analysis.cost import count_step, extrapolate
from repro_torch.analysis.roofline import model_flops, roofline_terms
from repro_torch.common.hw import H100_SXM
from repro_torch.configs import cells
from repro_torch.configs.shapes import shapes_for
from repro_torch.launch.specs import build_cell, cell_config
from repro_torch.models.sharding import rules_ctx

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")


def fake_process_group(world_size):
    """torch.distributed's "fake" backend over `world_size` ranks in this
    process, as rank 0 (a group of another size is torn down first)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() == world_size and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    try:    # registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    except ImportError:
        from torch._C._distributed_c10d import FakeProcessGroup
        dist.Backend.register_backend(
            "fake", lambda store, rank, size, timeout: FakeProcessGroup(
                rank, size), devices=["cpu"])
        store = dist.HashStore()
    dist.init_process_group("fake", store=store, rank=0,
                            world_size=world_size)


_MESHES = {}


def production_mesh(multi_pod):
    """The production mesh over a fake group of its size (kept)."""
    from repro_torch.launch.mesh import make_production_mesh
    n = 512 if multi_pod else 256
    fake_process_group(n)
    if n not in _MESHES:
        _MESHES.clear()
        _MESHES[n] = make_production_mesh(multi_pod=multi_pod)
    return _MESHES[n]


def local_args(args, shardings):
    """Meta tensors of this rank's slices of `args` (nested tuples, lists
    and dicts of global-shaped tensors) as `shardings` places them."""
    if isinstance(args, dict):
        return {k: local_args(args[k], shardings[k]) for k in args}
    if isinstance(args, (list, tuple)):
        return type(args)(local_args(a, s) for a, s in zip(args, shardings))
    return torch.empty(shardings.local_shape(tuple(args.shape)),
                       dtype=args.dtype, device="meta")


def count_cell(cell, mesh, multi_pod, rules, record_ops=False):
    """(CostMode, seconds) of rank 0's step of `cell` on meta tensors."""
    local = local_args(list(cell.args), list(cell.in_shardings))
    t0 = time.perf_counter()
    with rules_ctx(rules, mesh=mesh, pod_dp=multi_pod):
        out, mode = count_step(cell.fn, local, record_ops=record_ops)
    del out
    return mode, time.perf_counter() - t0


def _depths(cfg):
    """The depths a cell is counted at: two neighbouring depths for the
    families with a layer loop (1 and 2 for the LMs; 2 and 3 for NequIP,
    whose one-layer step leaves the last layer's gates out of the loss),
    else the config as it is."""
    lo = {"lm": 1, "gnn": 2}.get(cfg.family)
    if lo is not None and cfg.n_layers > lo + 1:
        return (lo, lo + 1)
    return (None,)


def run_cell(arch, shape, multi_pod, extra_rules=None, save_hlo=False,
             overrides=None, mesh=None, variant="full"):
    """The record of one cell. `mesh` (default: the production mesh over
    a fake group) and `variant` let the tests count smoke cells on a
    small fake mesh."""
    if mesh is None:
        mesh = production_mesh(multi_pod)
    n_dev = mesh.size
    cfg = cell_config(arch, overrides, variant)
    depths = _depths(cfg)
    counts, trace_s, ops = [], 0.0, None
    for depth in depths:
        o = dict(overrides or {})
        if depth is not None:
            o["n_layers"] = depth
        cell = build_cell(arch, shape, mesh, multi_pod, o, variant)
        rules = dict(cell.rules)
        if extra_rules:
            rules.update(extra_rules)
        mode, secs = count_cell(cell, mesh, multi_pod, rules, save_hlo)
        trace_s += secs
        counts.append({"cost": mode.cost(), "coll": mode.collectives(),
                       "arg": mode.arg_bytes,
                       "live": mode.peak_live_bytes})
        ops = mode.ops
        del mode
    if len(counts) == 2:
        c = extrapolate(counts[0], counts[1], cfg.n_layers, depths[0])
    else:
        c = counts[0]
    cost = {"flops": c["cost"]["flops"],
            "bytes accessed": c["cost"]["hbm_bytes"]}
    coll = dict(c["coll"])
    terms = roofline_terms(cost, coll, n_dev)
    mf = model_flops(cfg, shape)
    hbm = {"argument_gb": c["arg"] / 2 ** 30,
           "temp_gb": c["live"] / 2 ** 30}
    hbm["peak_gb"] = hbm["argument_gb"] + hbm["temp_gb"]
    rec = {
        "arch": arch, "shape": shape.name, "mode": shape.mode,
        "mesh": "x".join(map(str, mesh.devices_shape)), "n_devices": n_dev,
        "status": "ok",
        "trace_s": round(trace_s, 2),
        "memory": hbm,
        "fits_hbm_80g": hbm["peak_gb"] * 2 ** 30 <= H100_SXM.hbm_bytes,
        "roofline": terms,
        "collectives": coll,
        "model_flops": mf,
        "useful_flops_ratio": mf / max(terms["global_flops"], 1.0),
        "rules": {k: list(v) if isinstance(v, tuple) else v
                  for k, v in rules.items()},
        "overrides": dict(overrides or {}),
        "kernels": "plain",
        "counted_layers": [d for d in depths if d is not None],
    }
    if hasattr(cfg, "n_layers"):
        rec["n_layers"] = cfg.n_layers
    if save_hlo:
        os.makedirs(ART_DIR, exist_ok=True)
        rec["hlo_path"] = os.path.join(
            ART_DIR, f"{_cell_key(arch, shape.name, multi_pod)}.ops.txt")
        with open(rec["hlo_path"], "w") as f:
            f.write("\n".join(ops) + "\n")
    return rec


def _cell_key(arch, shape_name, multi_pod, tag=""):
    m = "multi" if multi_pod else "single"
    t = f"_{tag}" if tag else ""
    return f"{arch}__{shape_name}__{m}{t}".replace("/", "_")


def parse_value(v):
    return (int(v) if v.lstrip("-").isdigit()
            else True if v == "true"
            else False if v == "false" else v)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--save-hlo", action="store_true")
    ap.add_argument("--rules", default="",
                    help="logical=axis1+axis2|none,... sharding-rule overrides")
    ap.add_argument("--set", action="append", default=[],
                    help="arch-config overrides key=value (perf variants)")
    args = ap.parse_args(argv)

    extra_rules = {}
    for kv in args.rules.split(","):
        if not kv:
            continue
        k, v = kv.split("=")
        extra_rules[k] = None if v == "none" else tuple(v.split("+"))
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=")
        overrides[k] = parse_value(v)

    os.makedirs(ART_DIR, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    todo = []
    if args.arch in (None, "clusd-msmarco"):
        # the paper's own system: its cells beside the assigned ones
        for shape in shapes_for("retrieval").values():
            if not args.shape or shape.name == args.shape:
                todo.append(("clusd-msmarco", shape, None))
    if args.arch != "clusd-msmarco":
        for arch, shape, skip in cells():
            if args.arch and arch != args.arch:
                continue
            if args.shape and shape.name != args.shape:
                continue
            todo.append((arch, shape, skip))

    summary = {"ok": 0, "skip": 0, "fail": 0}
    for multi_pod in meshes:
        for arch, shape, skip in todo:
            key = _cell_key(arch, shape.name, multi_pod, args.tag)
            path = os.path.join(ART_DIR, key + ".json")
            if os.path.exists(path) and not args.force:
                print(f"[cached] {key}", flush=True)
                continue
            if skip:
                rec = {"arch": arch, "shape": shape.name,
                       "mesh": "2x16x16" if multi_pod else "16x16",
                       "status": "skip", "reason": skip}
                summary["skip"] += 1
            else:
                print(f"[run] {key} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, multi_pod, extra_rules,
                                   args.save_hlo, overrides)
                    summary["ok"] += 1
                    r = rec["roofline"]
                    print(f"  ok trace={rec['trace_s']}s "
                          f"peak={rec['memory']['peak_gb']:.2f}GiB "
                          f"dom={r['dominant']} "
                          f"t=({r['compute_s']:.2e},{r['memory_s']:.2e},"
                          f"{r['collective_s']:.2e})s "
                          f"useful={rec['useful_flops_ratio']:.3f}", flush=True)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape.name,
                           "mesh": "2x16x16" if multi_pod else "16x16",
                           "status": "fail", "error": str(e)[-2000:],
                           "traceback": traceback.format_exc()[-4000:]}
                    summary["fail"] += 1
                    print(f"  FAIL {type(e).__name__}: {str(e)[:300]}", flush=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    print("summary:", summary, flush=True)
    return 0 if summary["fail"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
