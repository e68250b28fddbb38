#!/usr/bin/env python3
"""Time the public embedding_bag op and the recsys serve step of two or
more checkouts of the port, on one NVIDIA GPU, in turns.

    git archive <commit> src/repro_torch | tar -x -C build/old
    python3 tools/compare_bag_op.py --roots build/old,. [--reps 400] \
        [--rounds 5]

Each turn is a fresh process that puts `<root>/src` first on its path,
builds that checkout's embedding_bag kernel into `<root>/build/kernels`
and, on wide-deep `full()`'s fused tables filled on the card from a
seeded torch.Generator (22,372,352 padded rows of d 32 and of d 1):

  - times the op on the recsys path's small bags, one call at a time
    with the host's clock (the op waits for its stream before it
    returns, so this is each call's latency): the user tower (1, 20, 32)
    and the serve-512 step's two bags, (512, 40, 32) and (512, 40, 1),
    over RecsysStream's Zipf ids (seed 1);
  - times `make_serve_step` on batches of 512 (serve_p99's shape) the
    same way, each call followed by a device sync, as chip_smoke.py
    times it.

Turns run old, new, ..., new, old over the roots (each root twice),
`--rounds` times over. Prints one JSON line a turn (p50 and mean ms of
each), the nvidia-smi line, and one JSON object last with each root's
p50s and, for each later root, how many rounds' turn pairs it won
against the first root (its p50 below the first root's in the same
half-round); exits non-zero without a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def child(root, reps):
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import RecsysStream
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.models import recsys as rs

    dev = torch.device("cuda", 0)
    cfg = get_config("wide-deep", "full")
    g = torch.Generator(device=dev).manual_seed(0)
    model = rs.RecsysModel(cfg, rs.init_params(cfg, g, device=dev),
                           device=dev)
    batches = [rs.as_batch({k: v for k, v in
                            RecsysStream(cfg, seed=1 + i).batch(512).items()
                            if k != "label"}, dev) for i in range(8)]
    sparse = batches[0]["sparse"]
    tables, wide = model.tables, model.wide
    n_user = len(cfg.table_sizes) // 2
    bags = {"user_tower": (tables.weight, (sparse[:1, :n_user]
                                           + tables.offsets[:n_user])),
            "deep_512": (tables.weight, sparse + tables.offsets),
            "wide_512": (wide.weight, sparse + wide.offsets)}
    bags = {k: (t, i.int().contiguous()) for k, (t, i) in bags.items()}
    torch.cuda.synchronize()

    def wall_ms(fn):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        return {"p50_ms": float(np.percentile(ms, 50)),
                "mean_ms": float(np.mean(ms))}

    out = {"root": root}
    for name, (table, idx) in bags.items():
        out[f"op_{name}"] = wall_ms(lambda: embedding_bag(table, idx))
    serve = rs.make_serve_step(cfg)
    i = [0]

    def step():
        serve(model, batches[i[0] % len(batches)])
        torch.cuda.synchronize()
        i[0] += 1
    with torch.inference_mode():
        out["serve_512"] = wall_ms(step)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", default=None,
                    help="comma-separated checkout roots, the old first")
    ap.add_argument("--reps", type=int, default=400)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child, args.reps)
    import torch
    if not torch.cuda.is_available():
        print("compare_bag_op: no CUDA device", file=sys.stderr)
        return 2
    roots = args.roots.split(",")
    order = (roots + roots[::-1]) * args.rounds
    rows = []
    for root in order:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root,
             "--reps", str(args.reps)], capture_output=True, text=True,
            check=False, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        rows.append(json.loads(line))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    keys = [k for k in rows[0] if k != "root"]
    summary = {root: {k: [r[k]["p50_ms"] for r in rows if r["root"] == root]
                      for k in keys} for root in roots}
    # a pair: the first root's and another root's turns in one half-round
    halves = [rows[i:i + len(roots)] for i in range(0, len(rows), len(roots))]
    wins = {root: {k: sum(
        next(r for r in h if r["root"] == root)[k]["p50_ms"]
        < next(r for r in h if r["root"] == roots[0])[k]["p50_ms"]
        for h in halves) for k in keys} for root in roots[1:]}
    print(json.dumps({"p50_ms": summary, "pairs": len(halves),
                      "wins_vs_first": wins}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
