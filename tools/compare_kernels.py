#!/usr/bin/env python3
"""Time the port's topk and adc_tables kernels against an older version of
their sources, on one NVIDIA GPU.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/old
    python3 tools/compare_kernels.py --old build/old [--profile]

Builds `<old>/src/repro_torch/csrc/{topk,adc}.cu` with nvcc (the port's
flags) into build/compare/, next to this checkout's kernels (built as
the port builds them), and times both on inputs shaped like the main
path's, made on the card from a seed:

  adc_tables: q (256, 768), codebooks (96, 256, 8) (PQ nsub 96, dsub 8);
  topk: the fuse rows (256, 2^20) at row stride 2^20 + 1 with about 9000
  nonzeros each, k 1000; the sparse rows (same view, 16,000 nonzeros),
  k 1000; Stage I (256, 8192) randn, k 32; the Stage-II budget (256, 32)
  with -inf, k 32; the recsys guide (1, 2^20) with 5 % -inf pads, k 1024;
  the recsys fuse and brute force (1, 2^20), k 100.

Each shape is timed by CUDA events over `--reps` launches after warm-up,
in turns old, new, new, old (both by their launch functions with the
outputs and scratch allocated once; `new_ms` is the public op, Python
included); both results are checked bitwise against
the plain version. `torch.topk` / `torch.einsum` are timed beside them,
and the bound (bytes over 3.35 TB/s, the H100 SXM's HBM rate).
`--profile` adds each topk device kernel's time by torch.profiler, the
old kernel's and the new one's (phase A, phase B). Prints one
line per shape, the nvidia-smi line and one JSON object last; exits
non-zero without a card.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def cuda_ms(fn, reps, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build(jobs):
    """jobs: {name: (source, extra flags)} -> {name: ctypes.CDLL}; one nvcc
    per job, all at once."""
    from repro_torch.kernels import build as kbuild
    out_dir = os.path.join(ROOT, "build", "compare")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (src, flags) in jobs.items():
        so = os.path.join(out_dir, f"{name}.so")
        cmd = [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, *flags, "-o", so, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def old_topk(lib):
    lib.topk_launch.argtypes = [_P, _LL, _I, _I, _I, _P, _P, _P]
    lib.topk_launch.restype = _I

    def run(x, k, vals, idx):
        rc = lib.topk_launch(x.data_ptr(), x.stride(0), x.shape[0],
                             x.shape[1], k, vals.data_ptr(), idx.data_ptr(),
                             stream())
        assert rc == 0, rc
    return run


def adc_launcher(lib):
    lib.adc_tables_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    lib.adc_tables_launch.restype = _I

    def run(q, books, out):
        nsub, K, dsub = books.shape
        rc = lib.adc_tables_launch(q.data_ptr(), books.data_ptr(),
                                   out.data_ptr(), q.shape[0], nsub, K, dsub,
                                   stream())
        assert rc == 0, rc
    return run


def kernel_ms(fn, match, reps=10):
    """{kernel name: mean device ms per call} by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {re.search(r"\w*" + match + r"\w*", e.key).group(0):
            e.device_time_total / reps / 1e3
            for e in prof.key_averages() if match in e.key}


def topk_inputs(g):
    dev = "cuda"
    n = 1 << 20
    out = {}
    for name, nnz in (("fused", 9000), ("sparse", 16000)):
        buf = torch.zeros(256, n + 1, device=dev)
        at = torch.randint(0, n, (256, nnz), device=dev, generator=g)
        buf.scatter_(1, at, torch.rand(256, nnz, device=dev, generator=g))
        buf[:, -1] = 7.0
        out[name] = (buf[:, :n], 1000)
    out["stage1"] = (torch.randn(256, 8192, device=dev, generator=g), 32)
    bud = torch.rand(256, 32, device=dev, generator=g)
    bud[bud < 0.5] = -torch.inf
    out["budget"] = (bud, 32)
    guide = torch.randn(1, n, device=dev, generator=g)
    guide[torch.rand(1, n, device=dev, generator=g) < 0.05] = -torch.inf
    out["guide"] = (guide, 1024)
    out["fuse_1m"] = (torch.randn(1, n, device=dev, generator=g), 100)
    return out


def bitwise(a, b):
    return (torch.equal(a[1], b[1])
            and torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="root of an older checkout (its src/repro_torch/csrc)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="device time of each topk kernel by torch.profiler")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "compare",
                                                  "compare_kernels.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.adc import adc_tables, adc_tables_ref
    from repro_torch.kernels.adc import kernel as adc_kernel
    from repro_torch.kernels.topk import kernel as tk
    from repro_torch.kernels.topk import topk, topk_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    old_csrc = os.path.join(os.path.abspath(args.old), "src", "repro_torch",
                            "csrc")
    jobs = {"old_topk": (os.path.join(old_csrc, "topk.cu"), []),
            "old_adc": (os.path.join(old_csrc, "adc.cu"), [])}
    libs = build(jobs)
    kbuild.build_all(("adc", "topk"))
    result = {"device": smi, "adc_tables": {}, "topk": {}}
    g = torch.Generator(device="cuda").manual_seed(0)

    # adc_tables
    q = torch.randn(256, 768, device="cuda", generator=g)
    books = torch.randn(96, 256, 8, device="cuda", generator=g)
    ref = adc_tables_ref(q, books)
    old_run = adc_launcher(libs["old_adc"])
    out_old = torch.empty_like(ref)
    old_run(q, books, out_old)
    new = adc_tables(q, books)
    torch.cuda.synchronize()
    ok = (torch.equal(new.view(torch.int32), ref.view(torch.int32))
          and torch.equal(out_old.view(torch.int32), ref.view(torch.int32)))
    qs = q.reshape(256, 96, 8)
    out_new = torch.empty_like(ref)
    reps = args.reps * 5
    t_old1 = cuda_ms(lambda: old_run(q, books, out_old), reps)
    t_new1 = cuda_ms(lambda: adc_kernel.adc_tables_cuda(q, books, out_new),
                     reps)
    t_new2 = cuda_ms(lambda: adc_kernel.adc_tables_cuda(q, books, out_new),
                     reps)
    t_old2 = cuda_ms(lambda: old_run(q, books, out_old), reps)
    lib_ms = cuda_ms(lambda: torch.einsum("bsd,skd->bsk", qs, books), reps)
    nbytes = 4 * (q.numel() + books.numel() + ref.numel())
    row = {"old_ms": [t_old1, t_old2], "new_launch_ms": [t_new1, t_new2],
           "new_ms": cuda_ms(lambda: adc_tables(q, books), reps),
           "einsum_ms": lib_ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bitwise": ok}
    if args.profile:
        row["device_ms"] = kernel_ms(
            lambda: adc_kernel.adc_tables_cuda(q, books, out_new), "adc")
        row["old_device_ms"] = kernel_ms(
            lambda: old_run(q, books, out_old), "adc")
    result["adc_tables"] = row
    print(f"adc_tables (256, 768) x (96, 256, 8): {row}", flush=True)
    if not ok:
        raise AssertionError("adc_tables is not bitwise the plain version")

    # topk
    run_old = old_topk(libs["old_topk"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bad = []
    for name, (x, k) in topk_inputs(g).items():
        B, D = x.shape
        vals = torch.empty(B, k, device="cuda")
        idx = torch.empty(B, k, dtype=torch.long, device="cuda")
        rv = topk_ref(x, k)
        run_old(x, k, vals, idx)
        new = topk(x, k)
        torch.cuda.synchronize()
        ok_new, ok_old = bitwise(new, rv), bitwise((vals, idx), rv)
        if not (ok_new and ok_old):
            bad.append(name)
        reps = args.reps if B > 1 else args.reps * 5
        plan = tk.plan(B, D, k, sms)
        scr = torch.empty(max(1, 2 * B * plan[0] * plan[2]),
                          dtype=torch.int32, device="cuda")

        def launch():
            tk.topk_cuda(x, k, vals, idx, scr, plan)
        t_old1 = cuda_ms(lambda: run_old(x, k, vals, idx), reps)
        t_new1 = cuda_ms(launch, reps)
        t_new2 = cuda_ms(launch, reps)
        t_old2 = cuda_ms(lambda: run_old(x, k, vals, idx), reps)
        lib_ms = cuda_ms(lambda: torch.topk(x, k), max(3, reps // 4))
        row = {"shape": [B, D], "row_stride": x.stride(0), "k": k,
               "plan": plan, "old_ms": [t_old1, t_old2],
               "new_launch_ms": [t_new1, t_new2],
               "new_ms": cuda_ms(lambda: topk(x, k), reps),
               "torch_topk_ms": lib_ms,
               "bound_ms": (4 * B * D + 12 * B * k) / HBM_BYTES_PER_S * 1e3,
               "bitwise_new": ok_new, "bitwise_old": ok_old}
        if args.profile:
            row["device_ms"] = kernel_ms(lambda: topk(x, k), "topk")
            row["old_device_ms"] = kernel_ms(
                lambda: run_old(x, k, vals, idx), "topk")
        result["topk"][name] = row
        print(f"topk {name}: {row}", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(smi)
    print(json.dumps(result))
    if bad:
        print(f"not bitwise the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
