#!/usr/bin/env python3
"""Time the port's topk, adc_tables, adc_score_blocks and lstm_sequence
kernels against an older version of their sources, on one NVIDIA GPU.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/old
    python3 tools/compare_kernels.py --old build/old [--profile]

Builds `<old>/src/repro_torch/csrc/{topk,adc,lstm}.cu` with nvcc (the
port's flags) into build/compare/, next to this checkout's kernels (built
as the port builds them), and times both on inputs shaped like the main
path's, made on the card from a seed:

  adc_tables: q (256, 768), codebooks (96, 256, 8) (PQ nsub 96, dsub 8);
  adc_score_blocks: the LUT (256, 96, 256) over the v2 batch's shape, 5173
  unique (256, 96) code blocks each reached by some of the (256, 32)
  positions, and over the PQStore batch's, the whole (8192, 256, 96) code
  table indexed by (256, 32) cluster ids; uniform random codes (and, to
  show what binds, codes that put a warp's lanes on 32 banks, and every
  slot on one block, whose codes then stay in L2);
  lstm_sequence: the v2 batch's (256, 32, 21) Stage-I features and the
  recsys query's (1, 32, 21), H 32 (randn, weights scaled by 1/sqrt(fan_in)),
  and the same batches over n 1 and 64 steps (the step's latency);
  topk: the fuse rows (256, 2^20) at row stride 2^20 + 1 with about 9000
  nonzeros each, k 1000; the sparse rows (same view, 16,000 nonzeros),
  k 1000; Stage I (256, 8192) randn, k 32; the Stage-II budget (256, 32)
  with -inf, k 32; the recsys guide (1, 2^20) with 5 % -inf pads, k 1024;
  the recsys fuse and brute force (1, 2^20), k 100.

Each shape is timed by CUDA events over `--reps` launches after warm-up,
in turns old, new, new, old (both by their launch functions with the
outputs and scratch allocated once; `new_ms` is the public op, Python
included); adc_score_blocks and lstm_sequence are timed by replaying a
CUDA graph of `--reps` launches (their launches are shorter than the
host's), in the same turns. adc_tables, adc_score_blocks and topk are
checked bitwise against the plain version, lstm_sequence within atol
1e-5. `torch.topk` / `torch.einsum` / `nn.LSTM` are timed beside them,
and the bound (bytes over 3.35 TB/s, the H100 SXM's HBM rate).
`--profile` adds each kernel's device time by torch.profiler, the old
kernel's and the new one's (for topk phase A and phase B). Prints one
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


def graph_ms(fn, reps):
    """Mean ms of fn() replayed from one CUDA graph of `reps` calls (the
    device's time, no host between launches)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * reps)


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


def old_topk(lib, sms):
    """The older topk.cu's launch through the chunked kernel's interface:
    its own plan, scratch of 2 * B * C * kstride words."""
    lib.topk_launch.argtypes = [_P, _LL, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                                _P]
    lib.topk_launch.restype = _I
    lib.topk_plan.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
    lib.topk_plan.restype = _I

    def prepare(x, k):
        B, D = x.shape
        out = (_I * 3)()
        assert lib.topk_plan(B, D, k, sms, out) == 0
        C, L, kstride = (int(v) for v in out)
        scr = torch.empty(max(1, 2 * B * C * kstride), dtype=torch.int32,
                          device=x.device)

        def run(vals, idx):
            rc = lib.topk_launch(x.data_ptr(), x.stride(0), B, D, k, C, L,
                                 kstride, vals.data_ptr(), idx.data_ptr(),
                                 scr.data_ptr() if C > 1 else None, stream())
            assert rc == 0, rc
        return run
    return prepare


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


def score_launcher(lib):
    lib.adc_score_blocks_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                            _I, _I, _P]
    lib.adc_score_blocks_launch.restype = _I

    def run(lut, codes, sel, out):
        B, nsub, K = lut.shape
        U, cap, _ = codes.shape
        rc = lib.adc_score_blocks_launch(
            lut.data_ptr(), codes.data_ptr(), sel.data_ptr(), out.data_ptr(),
            B, sel.shape[1], U, cap, nsub, K, stream())
        assert rc == 0, rc
    return run


def lstm_launcher(lib):
    lib.lstm_sequence_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                         _P]
    lib.lstm_sequence_launch.restype = _I

    def run(x, wx, wh, b, out):
        B, n, F = x.shape
        rc = lib.lstm_sequence_launch(
            x.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
            out.data_ptr(), B, n, F, wh.shape[0], stream())
        assert rc == 0, rc
    return run


def turns(old, new, timer):
    """old, new, new, old by `timer`: ([old ms x2], [new ms x2])."""
    t = [timer(old), timer(new), timer(new), timer(old)]
    return [t[0], t[3]], [t[1], t[2]]


def compare_adc_score(lib, g, args):
    """adc_score_blocks old against new on the v2 and PQStore shapes."""
    from repro_torch.kernels.adc import adc_score_blocks, adc_score_blocks_ref
    from repro_torch.kernels.adc import kernel as adc_kernel

    run_old = score_launcher(lib)
    B, S, cap, nsub = 256, 32, 256, 96
    lut = torch.randn(B, nsub, 256, device="cuda", generator=g)
    rows, bad = {}, []
    for name, U in (("v2", 5173), ("pq", 8192)):
        codes = torch.randint(0, 256, (U, cap, nsub), dtype=torch.uint8,
                              device="cuda", generator=g)
        if name == "v2":   # every unique block is reached, as dedup makes it
            sel = (torch.randperm(B * S, device="cuda", generator=g) % U)
        else:
            sel = torch.randint(0, U, (B * S,), device="cuda", generator=g)
        sel = sel.reshape(B, S).int().contiguous()
        ref = adc_score_blocks_ref(lut, codes, sel)
        out_old, out_new = torch.empty_like(ref), torch.empty_like(ref)
        run_old(lut, codes, sel, out_old)
        new = adc_score_blocks(lut, codes, sel)
        torch.cuda.synchronize()
        same = [torch.equal(t.view(torch.int32), ref.view(torch.int32))
                for t in (new, out_old)]
        if not all(same):
            bad.append(f"adc_score_blocks {name}")
        old_ms, new_ms = turns(
            lambda: run_old(lut, codes, sel, out_old),
            lambda: adc_kernel.adc_score_blocks_cuda(lut, codes, sel,
                                                     out_new),
            lambda fn: graph_ms(fn, args.reps))
        n_read = torch.unique(sel).numel()
        nbytes = 4 * lut.numel() + n_read * cap * nsub + 4 * sel.numel() \
            + 4 * ref.numel()
        row = {"shape": {"lut": list(lut.shape), "codes": [U, cap, nsub],
                         "sel": [B, S], "blocks_read": n_read},
               "old_ms": old_ms, "new_launch_ms": new_ms,
               "new_ms": graph_ms(lambda: adc_score_blocks(lut, codes, sel),
                                  args.reps),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bitwise_new": same[0], "bitwise_old": same[1]}
        # what binds: the same launch on codes that put the 32 lanes of a
        # warp on 32 banks (row c's code j is c % 32 + 32 * (j % 8)), on
        # one block for every slot (the codes stay in L2), and on both
        lanes = torch.arange(cap, device="cuda")[:, None] % 32
        free = (lanes + 32 * (torch.arange(nsub, device="cuda") % 8))
        free = free.to(torch.uint8).expand(U, cap, nsub).contiguous()
        one = torch.zeros_like(sel)
        row["floors_ms"] = {
            name: graph_ms(lambda: adc_kernel.adc_score_blocks_cuda(
                lut, c_, s_, out_new), args.reps)
            for name, c_, s_ in (("conflict_free", free, sel),
                                 ("one_block", codes, one),
                                 ("conflict_free_one_block", free, one))}
        del free
        if args.profile:
            row["device_ms"] = kernel_ms(
                lambda: adc_kernel.adc_score_blocks_cuda(lut, codes, sel,
                                                         out_new),
                "adc_score")
            row["old_device_ms"] = kernel_ms(
                lambda: run_old(lut, codes, sel, out_old), "adc_score")
        rows[name] = row
        print(f"adc_score_blocks {name}: {row}", flush=True)
        del codes, ref, out_old, out_new, new
    return rows, bad


def compare_lstm(lib, g, args):
    """lstm_sequence old against new, and nn.LSTM, on the (256, 32, 21)
    and (1, 32, 21) features."""
    from repro_torch.kernels.lstm import kernel as lstm_kernel
    from repro_torch.kernels.lstm import lstm_sequence, lstm_sequence_ref

    run_old = lstm_launcher(lib)
    F, H = 21, 32
    wx = torch.randn(F, 4 * H, device="cuda", generator=g) / F ** 0.5
    wh = torch.randn(H, 4 * H, device="cuda", generator=g) / H ** 0.5
    b = 0.1 * torch.randn(4 * H, device="cuda", generator=g)
    lstm = torch.nn.LSTM(F, H, batch_first=True).cuda()
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wx.T)
        lstm.weight_hh_l0.copy_(wh.T)
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    rows, bad = {}, []
    for B in (256, 1):
        x = torch.randn(B, 32, F, device="cuda", generator=g)
        ref = lstm_sequence_ref(x, wx, wh, b)
        out_old, out_new = torch.empty_like(ref), torch.empty_like(ref)
        run_old(x, wx, wh, b, out_old)
        new = lstm_sequence(x, wx, wh, b)
        torch.cuda.synchronize()
        errs = [(t - ref).abs().max().item() for t in (new, out_old)]
        if not max(errs) <= 1e-5:
            bad.append(f"lstm_sequence B {B}")
        reps = args.reps * 5
        old_ms, new_ms = turns(
            lambda: run_old(x, wx, wh, b, out_old),
            lambda: lstm_kernel.lstm_sequence_cuda(x, wx, wh, b, out_new),
            lambda fn: graph_ms(fn, reps))
        with torch.no_grad():
            lib_ms = graph_ms(lambda: lstm(x), reps)
        # the step's latency: the same launch over n 1 and n 64 steps
        steps_ms = {}
        for n in (1, 64):
            xn = torch.randn(B, n, F, device="cuda", generator=g)
            on = torch.empty(B, n, H, device="cuda")
            steps_ms[n] = graph_ms(lambda: lstm_kernel.lstm_sequence_cuda(
                xn, wx, wh, b, on), reps)
        row = {"shape": list(x.shape), "H": H, "old_ms": old_ms,
               "new_launch_ms": new_ms,
               "new_ms": graph_ms(lambda: lstm_sequence(x, wx, wh, b), reps),
               "nn_lstm_ms": lib_ms, "max_abs_err_new": errs[0],
               "max_abs_err_old": errs[1],
               "n1_ms": steps_ms[1], "n64_ms": steps_ms[64],
               "per_step_ms": (sum(new_ms) / 2 - steps_ms[1]) / 31}
        if args.profile:
            row["device_ms"] = kernel_ms(
                lambda: lstm_kernel.lstm_sequence_cuda(x, wx, wh, b, out_new),
                "lstm")
            row["old_device_ms"] = kernel_ms(
                lambda: run_old(x, wx, wh, b, out_old), "lstm")
        rows[f"B{B}"] = row
        print(f"lstm_sequence {tuple(x.shape)}: {row}", flush=True)
    return rows, bad


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
                    help="device time of each kernel by torch.profiler")
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
            "old_adc": (os.path.join(old_csrc, "adc.cu"), []),
            "old_lstm": (os.path.join(old_csrc, "lstm.cu"), [])}
    libs = build(jobs)
    kbuild.build_all(("adc", "lstm", "topk"))
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

    result["adc_score_blocks"], bad = compare_adc_score(libs["old_adc"], g,
                                                        args)
    result["lstm_sequence"], bad_l = compare_lstm(libs["old_lstm"], g, args)
    bad += bad_l

    # topk
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    prepare_old = old_topk(libs["old_topk"], sms)
    for name, (x, k) in topk_inputs(g).items():
        B, D = x.shape
        vals = torch.empty(B, k, device="cuda")
        idx = torch.empty(B, k, dtype=torch.long, device="cuda")
        rv = topk_ref(x, k)
        old = prepare_old(x, k)
        old(vals, idx)
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
        t_old1 = cuda_ms(lambda: old(vals, idx), reps)
        t_new1 = cuda_ms(launch, reps)
        t_new2 = cuda_ms(launch, reps)
        t_old2 = cuda_ms(lambda: old(vals, idx), reps)
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
            row["old_device_ms"] = kernel_ms(lambda: old(vals, idx),
                                             "topk")
        result["topk"][name] = row
        print(f"topk {name}: {row}", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(smi)
    print(json.dumps(result))
    if bad:
        print(f"disagree with the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
