#!/usr/bin/env python3
"""Where the dense LM's train step spends its time on one NVIDIA GPU: the
host or the device, and on the host, in what.

    python3 tools/profile_lm_step.py [--arch qwen2-1.5b] [--variant full] \
        [--batch 8] [--seq 128] [--steps 5] [--out build/lm_profile]

Random params from a seeded torch.Generator (the config's dtypes:
qwen2-1.5b `full()` computes in bfloat16 over float32 params, microbatch
4), tokens from numpy's default_rng(0). In one process it:

  - times the whole train step (`make_train_step`, host clock between
    device syncs) after 2 steps of warm-up, and reads the allocator's
    counters over those steps (cudaMalloc / cudaFree calls, retries);
  - times one microbatch's `value_and_grad` as the step runs it, and the
    same microbatch with the layers not recomputed (`remat` off), the
    forward alone with grad on, the forward under no_grad, the step's
    share outside its microbatches (the step less its microbatches), and
    the AdamW update alone (`adamw_update` with the step's settings on
    one microbatch's gradients) beside its bytes bound (7 passes over the
    float32 params at 3.35 TB/s: read g, mu, nu, p; write mu, nu, p);
  - profiles the whole step, that microbatch and the AdamW update with
    torch.profiler (CPU and CUDA activities): wall time, the device's
    busy time (the sum of its kernels' durations) and kernel count; for
    the microbatch also the count of aten ops and of CUDA runtime calls,
    and the 20 ops with the most host (self CPU) time;
  - times the host's cost of one tiny CUDA op (an in-place add on one
    float), with and without an autograd node, to say what a dispatch
    costs on this host.

Writes the profiler's table to `<out>/ops.txt`, prints the nvidia-smi
line, and prints one JSON object last. Exits non-zero without a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _sync():
    import torch
    torch.cuda.synchronize()


def _wall_ms(fn, reps):
    out = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)[len(out) // 2]


def _dispatch_us(n=20000):
    """Host microseconds for one tiny CUDA op: an in-place add, then a
    chain of out-of-place muls that autograd records, with its backward."""
    import torch
    x = torch.zeros(1, device="cuda")
    for _ in range(100):
        x.add_(1)
    _sync()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    t_add = (time.perf_counter() - t0) * 1e6 / n
    _sync()
    w = torch.ones(1, device="cuda", requires_grad=True)
    m = 2000
    _sync()
    t0 = time.perf_counter()
    y = w
    for _ in range(m):
        y = y * 1.0001
    t_fwd = (time.perf_counter() - t0) * 1e6 / m
    t0 = time.perf_counter()
    torch.autograd.grad(y, [w])
    _sync()
    t_bwd = (time.perf_counter() - t0) * 1e6 / m
    return {"add_us": t_add, "mul_with_grad_us": t_fwd,
            "mul_backward_us": t_bwd}


def _profiled(fn):
    """Wall ms, device busy ms and kernel count of one profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"wall_ms": wall, "kernels": len(kern),
            "device_busy_ms": sum(e.time_range.elapsed_us()
                                  for e in kern) / 1e3}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--variant", default="full")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join("build", "lm_profile"))
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.common import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import transformer as tt
    from repro_torch.optim import adamw_init, adamw_update

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(args.arch, args.variant)
    params = tt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    state = {"p": params, "o": adamw_init(params)}
    del params
    step = tt.make_train_step(cfg)
    t = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.seq + 1)).astype(np.int32)
    t = torch.from_numpy(t).to(dev)
    batch = {"tokens": t[:, :-1].contiguous(),
             "labels": t[:, 1:].contiguous()}
    m = cfg.microbatch if cfg.microbatch and args.batch % cfg.microbatch \
        == 0 else 1
    mb = {k: v[:args.batch // m] for k, v in batch.items()}
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "params": cfg.param_count(), "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype, "microbatch": m,
           "batch": args.batch, "seq": args.seq,
           "host_cpus": os.cpu_count(),
           "torch_threads": torch.get_num_threads(),
           "torch": torch.__version__}

    def one_step():
        state["p"], state["o"], _ = step(state["p"], state["o"], batch)

    for _ in range(2):
        one_step()
    _sync()
    m0 = torch.cuda.memory_stats()
    steps = []
    for _ in range(args.steps):
        steps.append(_wall_ms(one_step, 1))
    m1 = torch.cuda.memory_stats()
    res["step_ms"] = steps
    res["step_ms_p50"] = float(np.percentile(steps, 50))
    res["alloc_per_step"] = {
        k: (m1.get(k, 0) - m0.get(k, 0)) / args.steps
        for k in ("num_device_alloc", "num_device_free",
                  "num_alloc_retries", "num_sync_all_streams")}
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["step_profile"] = _profiled(one_step)
    params = state["p"]

    def vg(c):
        return lambda: tt.value_and_grad(c, params, mb)

    def fwd(p):
        hidden = tt.forward(cfg, p, mb["tokens"])[0]
        return tt.lm_loss(cfg, hidden, p["lm_head"], mb["labels"])

    def fwd_grad():
        leaves = [p.detach().requires_grad_() for p in tu.tree_leaves(params)]
        with torch.enable_grad():
            fwd(tu.tree_unflatten_like(params, leaves))

    def fwd_nograd():
        with torch.no_grad():
            fwd(params)

    reps = 5
    res["microbatch_ms"] = _wall_ms(vg(cfg), reps)
    res["microbatch_no_remat_ms"] = _wall_ms(
        vg(dataclasses.replace(cfg, remat=False)), reps)
    res["forward_grad_ms"] = _wall_ms(fwd_grad, reps)
    res["forward_nograd_ms"] = _wall_ms(fwd_nograd, reps)
    res["outside_microbatches_ms"] = res["step_ms_p50"] \
        - m * res["microbatch_ms"]
    tc = TrainConfig()
    grads = tt.value_and_grad(cfg, params, mb)[1]

    def update():
        adamw_update(grads, state["o"], params, lr=tc.lr, b1=tc.b1,
                     b2=tc.b2, eps=tc.eps, weight_decay=tc.weight_decay,
                     grad_clip=tc.grad_clip)

    res["adamw_ms"] = _wall_ms(update, 3)
    res["adamw_profile"] = _profiled(update)
    res["adamw_bound_ms"] = cfg.param_count() * 4 * 7 / 3.35e12 * 1e3
    del grads

    vg(cfg)()
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        vg(cfg)()
        _sync()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    res["profiled_microbatch_ms"] = wall
    res["device_busy_ms"] = sum(e.time_range.elapsed_us()
                                for e in kern) / 1e3
    res["kernels"] = len(kern)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    res["aten_ops"] = sum(1 for e in cpu if e.name.startswith("aten::"))
    api = {}
    for e in cpu:
        if e.name.startswith("cuda") or e.name.startswith("cu"):
            c, us = api.get(e.name, (0, 0.0))
            api[e.name] = (c + 1, us + e.time_range.elapsed_us())
    res["cuda_api"] = {k: {"calls": c, "ms": us / 1e3}
                       for k, (c, us) in sorted(api.items(),
                                                key=lambda x: -x[1][1])}
    ka = prof.key_averages()
    top = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:20]
    res["top_self_cpu"] = [
        {"name": e.key, "calls": e.count,
         "self_cpu_ms": e.self_cpu_time_total / 1e3,
         "us_a_call": e.self_cpu_time_total / max(e.count, 1)}
        for e in top]
    res["self_cpu_ms_total"] = sum(e.self_cpu_time_total
                                   for e in ka) / 1e3
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "ops.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cpu_time_total", row_limit=60))
    res["dispatch"] = _dispatch_us()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi failed: {e}"
    res["gpu"] = smi
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
