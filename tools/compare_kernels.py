#!/usr/bin/env python3
"""Time the port's topk, adc_tables, adc_score_blocks, lstm_sequence,
bin_overlap, embedding_bag and cluster_score kernels against an older
version of their sources, on one NVIDIA GPU.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/old
    python3 tools/compare_kernels.py --old build/old [--profile] \
        [--kernels bin_overlap,embedding_bag]

Builds `<old>/src/repro_torch/csrc/<name>.cu` for the kernels asked for
(all by default) with nvcc (the port's flags) into build/compare/, next
to this checkout's kernels (built as the port builds them), and times
both on inputs shaped like the main path's, made on the card from a
seed:

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
  the recsys fuse and brute force (1, 2^20), k 100;
  bin_overlap: Stage I's (256, 1000) results over N 8192 clusters and
  the recsys query's (1, 1024) over N 4096, v 7 rank bins, clusters
  drawn from a Zipf-like law (runs of equal slots);
  embedding_bag: wide-deep full()'s fused tables (22,372,352 padded rows
  of d 32, and of d 1 for the wide branch) with the recsys path's four
  bags: the guide (2^20, 2, 1) and the candidate tower (2^20, 2, 32)
  over uniform ids of the two 10M-row fields, the bulk wide bag
  (262,144, 40, 1) and the small one (512, 40, 1) over RecsysStream's
  Zipf ids, the user tower (1, 20, 32); and B from 1 to 32,768 across
  the warp-per-bag threshold (2048 bags) at hot 40 / d 1, hot 20 / d 32
  and hot 2 / d 1, uniform ids;
  cluster_score: unit-norm (256, 768) float blocks at the v1 tail's,
  the memory store's, the label chunk's and a distributed rank's
  selections (see compare_cluster_score), timed by CUDA-graph replay
  (`new_ms` the public op, its scratch allocation included).

Each shape is timed by CUDA events over `--reps` launches after warm-up,
in turns old, new, new, old (both by their launch functions with the
outputs and scratch allocated once; `new_ms` is the public op, Python
included); adc_score_blocks and lstm_sequence are timed by replaying a
CUDA graph of `--reps` launches (their launches are shorter than the
host's), in the same turns. adc_tables, adc_score_blocks and topk are
checked bitwise against the plain version, lstm_sequence within atol
1e-5. bin_overlap and embedding_bag are timed by CUDA-graph replay in
the same turns and held bitwise to their plain versions (bin_overlap's
on the CPU); `new_ms` is the public op's eager time with CUDA events
(embedding_bag's includes its stream sync and error-word read, and
`old_wrapper_ms` the old wrapper's aminmax range check and host sync
before its launch). `torch.topk` / `torch.einsum` / `nn.LSTM` /
`F.embedding_bag` are timed beside them, and the bound (bytes over 3.35
TB/s, the H100 SXM's HBM rate; embedding_bag adds the sector floor, its
table reads counted as the distinct 32-byte sectors the ids touch, and
bin_overlap the write floor, PyTorch's fill of its two outputs).
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
sys.path.insert(0, ROOT)

from chip_smoke import table_sectors  # noqa: E402

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
        err = torch.zeros(1, dtype=torch.int64, device="cuda")
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
        err = torch.zeros(1, dtype=torch.int64, device="cuda")
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


def overlap_launcher(lib):
    lib.bin_overlap_launch.argtypes = [_P, _P, _I, _P, _P, _P, _I, _I, _I,
                                       _I, _P]
    lib.bin_overlap_launch.restype = _I

    def run(c_of, bins, scores, P, Q, N, v):
        B, k = c_of.shape
        rc = lib.bin_overlap_launch(
            c_of.data_ptr(), bins.data_ptr(), 0 if bins.dim() == 1 else k,
            scores.data_ptr(), P.data_ptr(), Q.data_ptr(), B, k, N, v,
            stream())
        assert rc == 0, rc
    return run


def compare_bin_overlap(lib, g, args):
    """bin_overlap old against new on Stage I's (256, 1000) at N 8192 and
    the recsys query's (1, 1024) at N 4096, v 7."""
    from repro_torch.kernels.bin_overlap import bin_overlap, bin_overlap_ref
    from repro_torch.kernels.bin_overlap import kernel as bo_kernel

    run_old = overlap_launcher(lib)
    v, rows, bad = 7, {}, []
    edges = torch.tensor([10, 25, 50, 100, 200, 500, 1000], device="cuda")
    for name, (B, k, N) in (("stage1", (256, 1000, 8192)),
                            ("recsys", (1, 1024, 4096))):
        # cluster ids from a heavy-tailed law: some clusters hold many of
        # a query's results, as the sparse top-k's do
        u = torch.rand(B, k, device="cuda", generator=g)
        c_of = ((u ** 3) * N).int().clamp(max=N - 1).contiguous()
        bins = torch.bucketize(torch.arange(k, device="cuda"), edges,
                               right=True).int().clamp(max=v - 1)
        scores = torch.rand(B, k, device="cuda", generator=g)
        rP, rQ = bin_overlap_ref(c_of.cpu(), bins.cpu(), scores.cpu(),
                                 n_clusters=N, v=v)
        P, Q = torch.empty(B, N, v, device="cuda"), torch.empty(
            B, N, v, device="cuda")
        oP, oQ = torch.empty_like(P), torch.empty_like(Q)
        run_old(c_of, bins, scores, oP, oQ, N, v)
        nP, nQ = bin_overlap(c_of, bins, scores, n_clusters=N, v=v)
        torch.cuda.synchronize()
        same = [torch.equal(a.cpu(), rP) and torch.equal(
                    b.cpu().view(torch.int32), rQ.view(torch.int32))
                for a, b in ((nP, nQ), (oP, oQ))]
        if not all(same):
            bad.append(f"bin_overlap {name}")
        reps = args.reps if B > 1 else args.reps * 5
        old_ms, new_ms = turns(
            lambda: run_old(c_of, bins, scores, oP, oQ, N, v),
            lambda: bo_kernel.bin_overlap_cuda(c_of, bins, scores, P, Q, N,
                                               v),
            lambda fn: graph_ms(fn, reps))
        nbytes = 8 * B * N * v + 8 * B * k + 4 * bins.numel()
        row = {"shape": {"c_of": [B, k], "N": N, "v": v},
               "old_ms": old_ms, "new_launch_ms": new_ms,
               "new_graph_ms": graph_ms(lambda: bin_overlap(
                   c_of, bins, scores, n_clusters=N, v=v), reps),
               "new_ms": cuda_ms(lambda: bin_overlap(
                   c_of, bins, scores, n_clusters=N, v=v), reps),
               "plain_ms": cuda_ms(lambda: bin_overlap_ref(
                   c_of, bins, scores, n_clusters=N, v=v), 5),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               # what the writes alone take: one fill of P and one of Q
               "write_floor_ms": graph_ms(lambda: (P.fill_(0.0),
                                                   Q.fill_(0.0)), reps),
               "bitwise_new": same[0], "bitwise_old": same[1]}
        if args.profile:
            row["device_ms"] = kernel_ms(
                lambda: bo_kernel.bin_overlap_cuda(c_of, bins, scores, P, Q,
                                                   N, v), "overlap")
            row["old_device_ms"] = kernel_ms(
                lambda: run_old(c_of, bins, scores, oP, oQ, N, v), "overlap")
        rows[name] = row
        print(f"bin_overlap {name}: {row}", flush=True)
    return rows, bad


def old_bag_launcher(lib):
    """The older embedding_bag.cu's launch: no range check, no error word."""
    lib.embedding_bag_launch.argtypes = [_P, _P, _P, _LL, _I, _I, _I, _P]
    lib.embedding_bag_launch.restype = _I

    def run(table, idx, out):
        B, hot = idx.shape
        rc = lib.embedding_bag_launch(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), B, hot,
            table.shape[1], 0, stream())
        assert rc == 0, rc
    return run


def bag_inputs(g):
    """wide-deep full()'s fused tables (random) and the recsys path's four
    bags over them: {name: (table, idx)}."""
    from repro_torch.configs import get_config
    from repro_torch.data import RecsysStream
    from repro_torch.models.recsys import _padded_rows

    cfg = get_config("wide-deep", "full")
    rows = [_padded_rows(r) for r in cfg.table_sizes]
    offsets = torch.tensor([0] + rows[:-1], device="cuda").cumsum(0).int()
    deep = torch.randn(sum(rows), cfg.embed_dim, device="cuda", generator=g)
    wide = torch.randn(sum(rows), 1, device="cuda", generator=g)
    n = 1 << 20
    cand = torch.stack([torch.randint(0, cfg.table_sizes[i], (n,),
                                      device="cuda", generator=g)
                        for i in range(2)], 1).int() + offsets[:2]
    stream = RecsysStream(cfg, seed=1)
    n_user = len(cfg.table_sizes) // 2
    ids = {B: torch.from_numpy(stream.batch(B)["sparse"]).cuda() + offsets
           for B in (512, 262144)}
    return {"guide": (wide, cand.contiguous()),
            "user_tower": (deep, ids[512][:1, :n_user].contiguous()),
            "serve_wide": (wide, ids[262144].contiguous()),
            "serve_wide_512": (wide, ids[512].contiguous()),
            "candidate_tower": (deep, cand.contiguous())}


def compare_embedding_bag(lib, g, args):
    """embedding_bag old against new on the recsys path's bags."""
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_ref)
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    from repro_torch.kernels.embedding_bag.ops import _check_range

    run_old = old_bag_launcher(lib)
    rows, bad = {}, []
    inputs = bag_inputs(g)
    # B across the warp-per-bag threshold (2048 bags), uniform ids over
    # the same tables: hot 40 at d 1, hot 20 at d 32, hot 2 at d 1
    wide, deep = inputs["guide"][0], inputs["user_tower"][0]
    for hot, table in ((40, wide), (20, deep), (2, wide)):
        for B in (1, 512, 2048, 2049, 8192, 32768):
            inputs[f"sweep_hot{hot}_d{table.shape[1]}_B{B}"] = (
                table, torch.randint(0, table.shape[0], (B, hot),
                                     device="cuda", generator=g,
                                     dtype=torch.int32))
    for name, (table, idx) in inputs.items():
        B, hot = idx.shape
        d = table.shape[1]
        ref = embedding_bag_ref(table, idx)
        out_old, out_new = torch.empty_like(ref), torch.empty_like(ref)
        err = torch.zeros(1, dtype=torch.int64, device="cuda")
        run_old(table, idx, out_old)
        new = embedding_bag(table, idx)
        torch.cuda.synchronize()
        same = [torch.equal(t.view(torch.int32), ref.view(torch.int32))
                for t in (new, out_old)]
        if not all(same):
            bad.append(f"embedding_bag {name}")
        reps = args.reps if B > 512 else args.reps * 5

        def old_wrapper():
            _check_range(idx, table.shape[0])
            run_old(table, idx, out_old)
        old_ms, new_ms = turns(
            lambda: run_old(table, idx, out_old),
            lambda: eb_kernel.embedding_bag_cuda(table, idx, out_new, err),
            lambda fn: graph_ms(fn, reps))
        n_rows = torch.unique(idx).numel()
        io = 4 * idx.numel() + 4 * B * d
        row = {"shape": [B, hot, d], "rows_read": n_rows,
               "old_ms": old_ms, "new_launch_ms": new_ms,
               "old_wrapper_ms": cuda_ms(old_wrapper, reps),
               "new_ms": cuda_ms(lambda: embedding_bag(table, idx), reps),
               "library_ms": graph_ms(lambda: torch.nn.functional.
                                      embedding_bag(idx, table, mode="sum"),
                                      reps),
               "bound_ms": (4 * n_rows * d + io) / HBM_BYTES_PER_S * 1e3,
               "sector_floor_ms": (32 * table_sectors(table, idx) + io)
               / HBM_BYTES_PER_S * 1e3,
               "bitwise_new": same[0], "bitwise_old": same[1]}
        if args.profile:
            row["device_ms"] = kernel_ms(
                lambda: eb_kernel.embedding_bag_cuda(table, idx, out_new, err),
                "bag")
            row["old_device_ms"] = kernel_ms(
                lambda: run_old(table, idx, out_old), "bag")
        rows[name] = row
        print(f"embedding_bag {name}: {row}", flush=True)
        del ref, out_old, out_new, new
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


def compare_adc_tables(lib, g, args):
    """adc_tables old against new on q (256, 768), codebooks (96, 256, 8)."""
    from repro_torch.kernels.adc import adc_tables, adc_tables_ref
    from repro_torch.kernels.adc import kernel as adc_kernel

    q = torch.randn(256, 768, device="cuda", generator=g)
    books = torch.randn(96, 256, 8, device="cuda", generator=g)
    ref = adc_tables_ref(q, books)
    old_run = adc_launcher(lib)
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
    print(f"adc_tables (256, 768) x (96, 256, 8): {row}", flush=True)
    return row, [] if ok else ["adc_tables"]


def compare_topk(lib, g, args):
    """topk old against new on topk_inputs' rows."""
    from repro_torch.kernels.topk import kernel as tk
    from repro_torch.kernels.topk import topk, topk_ref

    rows, bad = {}, []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    prepare_old = old_topk(lib, sms)
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
        rows[name] = row
        print(f"topk {name}: {row}", flush=True)
    return rows, bad


# kernel -> the csrc source that holds it, and its comparison
def cluster_launcher(lib):
    """The PR 13 cluster_score.cu's launch: one CTA per slot, no scratch."""
    lib.cluster_score_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         _P]
    lib.cluster_score_launch.restype = _I

    def run(q, blocks, sel, out):
        U, cap, dim = blocks.shape
        rc = lib.cluster_score_launch(
            q.data_ptr(), blocks.data_ptr(), sel.data_ptr(), out.data_ptr(),
            q.shape[0], sel.shape[1], U, cap, dim, stream())
        assert rc == 0, rc
    return run


def compare_cluster_score(lib, g, args):
    """cluster_score old against new on unit-norm float32 blocks of (256,
    768): the v1 tail (5173 unique blocks, each reached by one or two of
    the (256, 32) positions), the memory store (the whole (8192, 256,
    768) table by uniform cluster ids), the label chunk (512 queries x
    64 blocks, every query on every block; q @ blocks^T beside it) and a
    distributed rank (2048 local blocks, the ids of the other ranks'
    clusters clamped to the last local block: one run of about 6144
    slots). Held to the plain version at rtol 1e-5, atol 1e-6; bound as
    chip_smoke.py counts it."""
    from repro_torch.kernels.cluster_score import (cluster_score,
                                                   cluster_score_ref,
                                                   group_slots_ref)

    run_old = cluster_launcher(lib)
    cap, dim = 256, 768

    def unit(*shape):
        x = torch.randn(*shape, device="cuda", generator=g)
        return x / x.norm(dim=-1, keepdim=True)

    rows, bad = {}, []
    for name in ("v1_tail", "memory", "label_chunk", "distributed"):
        B, S = (512, 64) if name == "label_chunk" else (256, 32)
        U = {"v1_tail": 5173, "memory": 8192, "label_chunk": 64,
             "distributed": 2048}[name]
        q = unit(B, dim)
        blocks = torch.empty(U, cap, dim, device="cuda")
        for lo in range(0, U, 512):           # in pieces: no second copy
            blocks[lo:lo + 512] = unit(min(512, U - lo), cap, dim)
        if name == "v1_tail":
            sel = torch.randperm(B * S, device="cuda", generator=g) % U
        elif name == "label_chunk":
            sel = torch.arange(U, device="cuda").expand(B, U)
        else:
            sel = torch.randint(0, 8192, (B, S), device="cuda", generator=g)
            sel = sel.clamp(0, U - 1)
        sel = sel.reshape(B, S).int().contiguous()
        out_old = torch.empty(B, S, cap, device="cuda")
        run_old(q, blocks, sel, out_old)
        new = cluster_score(q, blocks, sel)
        ref = cluster_score_ref(q, blocks, sel)
        torch.cuda.synchronize()
        errs = [(t - ref).abs().max().item() for t in (new, out_old)]
        if not torch.allclose(new, ref, rtol=1e-5, atol=1e-6):
            bad.append(f"cluster_score {name}")
        del ref
        old_ms, new_ms = turns(lambda: run_old(q, blocks, sel, out_old),
                               lambda: cluster_score(q, blocks, sel),
                               lambda fn: graph_ms(fn, args.reps))
        n_read = torch.unique(sel).numel()
        nbytes = 4 * (n_read * cap * dim + B * dim + B * S * cap + B * S)
        flops = 2 * B * S * cap * dim
        _, _, _, items = group_slots_ref(sel, U, cap)
        gemm = int((items[:, 2] >= 32).sum())
        row = {"shape": {"q": [B, dim], "blocks": [U, cap, dim],
                         "sel": [B, S], "blocks_read": n_read,
                         "gemm_items": gemm,
                         "bytes_items": items.shape[0] - gemm},
               "old_ms": old_ms, "new_ms": new_ms,
               "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / 67e12)
               * 1e3,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
               >= flops / 67e12 else "operations",
               "max_abs_err_new": errs[0], "max_abs_err_old": errs[1]}
        if name == "label_chunk":
            flat = blocks.reshape(U * cap, dim)
            row["library_ms"] = graph_ms(lambda: q @ flat.T, args.reps)
        if args.profile:
            row["device_ms"] = kernel_ms(
                lambda: cluster_score(q, blocks, sel), "_kernel")
        rows[name] = row
        print(f"cluster_score {name}: {row}", flush=True)
        del blocks, new, out_old
        torch.cuda.empty_cache()
    return rows, bad


KERNELS = {"adc_tables": ("adc", compare_adc_tables),
           "adc_score_blocks": ("adc", compare_adc_score),
           "lstm_sequence": ("lstm", compare_lstm),
           "topk": ("topk", compare_topk),
           "bin_overlap": ("bin_overlap", compare_bin_overlap),
           "embedding_bag": ("embedding_bag", compare_embedding_bag),
           "cluster_score": ("cluster_score", compare_cluster_score)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="root of an older checkout (its src/repro_torch/csrc)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="device time of each kernel by torch.profiler")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ",".join(KERNELS))
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "compare",
                                                  "compare_kernels.json"))
    args = ap.parse_args()
    wanted = args.kernels.split(",")
    if not set(wanted) <= set(KERNELS):
        ap.error(f"--kernels: unknown {sorted(set(wanted) - set(KERNELS))}")
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build as kbuild

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    old_csrc = os.path.join(os.path.abspath(args.old), "src", "repro_torch",
                            "csrc")
    sources = sorted({KERNELS[k][0] for k in wanted})
    libs = build({f"old_{src}": (os.path.join(old_csrc, f"{src}.cu"), [])
                  for src in sources})
    kbuild.build_all(sources)
    result, bad = {"device": smi}, []
    g = torch.Generator(device="cuda").manual_seed(0)
    for name in wanted:
        src, compare = KERNELS[name]
        result[name], b = compare(libs[f"old_{src}"], g, args)
        bad += b
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
