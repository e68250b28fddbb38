#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printed with its seconds:
  1. the card (nvidia-smi name and power limit, torch's device name);
  2. the CUDA kernels of src/repro_torch/csrc, built with nvcc for
     sm_90a (one nvcc per source, all at once), with -Xptxas -v output;
  3. the state at the paper's widths (configs/clusd_msmarco.py `full()`:
     dim 768, N 8192, vocab 30522, k_sparse 1000, n 32, H 32, PQ nsub 96),
     cut to 2^20 synthetic docs (cap 256), built on the card by the
     port's own build side and written as 8 code shards; a sha256 of
     the built state shows that one seed builds one state;
  4. serving: RetrievalEngine over ShardedPQStore answers 1024 queries
     in batches of 256 (the first batch is warm-up); every kernel's
     launch count over that run must be > 0;
  5. torch.profiler over one steady batch: device busy share and the
     device time by kernel;
  6. each kernel against its plain PyTorch version on the inputs the
     engine's stage functions make for the last batch of queries, timed
     with CUDA events beside one PyTorch call of the same function where
     there is one, and its bound;
  7. parity: the same 16 queries served on the card and on the CPU
     (plain versions) must agree.

Prints the kernel table as one JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure exits non-zero; without a
card it exits 2 before doing anything.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
N_DOCS = 1 << 20          # the one cut: 8.8M MS MARCO passages -> 2^20
NSUB = 96                 # PQ: dsub 8, 96 bytes per passage
N_SHARDS = 8
N_QUERIES = 1024
MAX_BATCH = 256
PARITY_QUERIES = 16
PARITY_GAP = 1e-5
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside the tensor cores


def phase(name):
    """Context manager printing a phase's seconds."""
    class _P:
        def __enter__(self):
            print(f"== {name}", flush=True)
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, exc_type, *exc):
            if exc_type is None:
                print(f"== {name}: {time.perf_counter() - self.t0:.2f} s",
                      flush=True)
            return False
    return _P()


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds of fn() on the card, by CUDA events."""
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


def bound(nbytes, flops):
    """(ms, "bytes"|"operations"): the least time for this work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path_inputs(cfg, index, store, qs, dev):
    """The kernels' inputs for the last batch of MAX_BATCH queries, made by
    the engine's own stage functions as RetrievalEngine runs them:
    queries, the LUT, Stage-I features, the batch's unique code blocks
    and each slot's position among them."""
    from repro_torch.engine import pipeline as pipe_lib

    sl = slice(len(qs.rel_doc) - MAX_BATCH, None)
    qd = torch.tensor(qs.q_dense[sl], dtype=torch.float32).to(dev)
    qt = torch.tensor(qs.q_terms[sl], dtype=torch.int32).to(dev)
    qw = torch.tensor(qs.q_weights[sl], dtype=torch.float32).to(dev)
    with torch.no_grad():
        _, _, cand, feats = pipe_lib.build_stage1_fn(cfg, index)(qd, qt, qw)
        lut = pipe_lib.build_lut_fn(store.codebooks, store.rotation,
                                    dev)(qd)
        sel_ids, sel_mask, _ = pipe_lib.build_stage2_fn(cfg, index)(cand,
                                                                    feats)
    uniq, pos = pipe_lib.dedup_selected(sel_ids.cpu().numpy(),
                                        sel_mask.cpu().numpy())
    blocks = pipe_lib.fetch_unique_code_blocks(store, uniq)
    return {"q": qd, "lut": lut, "feats": feats.float().contiguous(),
            "blocks": torch.from_numpy(blocks).to(dev),
            "pos": torch.from_numpy(pos).to(dev)}


def check_kernels(dev, launches, inputs, pq, selector):
    """Each kernel vs its plain version on the main path's inputs."""
    from repro_torch.kernels.adc import (adc_score_blocks,
                                         adc_score_blocks_ref, adc_tables,
                                         adc_tables_ref)
    from repro_torch.kernels.lstm import lstm_sequence, lstm_sequence_ref

    rows = []

    # adc_tables: (B, dim) queries, (nsub, K, dsub) codebooks
    q, books = inputs["q"], pq.codebooks
    B, dim = q.shape
    nsub, K, dsub = books.shape
    lut = adc_tables(q, books)
    ref = adc_tables_ref(q, books)
    torch.cuda.synchronize()
    err = (lut - ref).abs().max().item()
    if not torch.allclose(lut, ref, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"adc_tables disagrees with plain: {err}")
    qs = q.reshape(B, nsub, dsub)
    lib = torch.einsum("bsd,skd->bsk", qs, books)
    lib_err = (lib - ref).abs().max().item()
    b_ms, b_by = bound(4 * (B * dim + books.numel() + B * nsub * K),
                       2 * B * nsub * K * dsub)
    rows.append({"name": "adc_tables", "route": "cuda",
                 "source": "src/repro_torch/csrc/adc.cu",
                 "replaces": "src/repro/kernels/adc/kernel.py:38",
                 "launches": launches["adc_tables"], "max_abs_err": err,
                 "ms": cuda_ms(lambda: adc_tables(q, books), 50),
                 "plain_ms": cuda_ms(lambda: adc_tables_ref(q, books), 10),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": cuda_ms(lambda: torch.einsum(
                     "bsd,skd->bsk", qs, books), 50),
                 "shapes": [(B, dim), (nsub, K, dsub)],
                 "library_max_abs_err": lib_err})

    # adc_score_blocks: the batch's LUT, unique code blocks and positions
    lut, codes, sel = inputs["lut"], inputs["blocks"], inputs["pos"]
    U, cap, _ = codes.shape
    S = sel.shape[1]
    out = adc_score_blocks(lut, codes, sel)
    ref = adc_score_blocks_ref(lut, codes, sel)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("adc_score_blocks is not bitwise the plain "
                             f"version: {(out - ref).abs().max().item()}")
    # bytes: the LUTs, the code blocks that `sel` reaches, `sel`, the scores
    n_read = torch.unique(sel).numel()
    b_ms, b_by = bound(4 * B * nsub * K + n_read * cap * nsub + 4 * B * S
                       + 4 * B * S * cap, B * S * cap * nsub)
    rows.append({"name": "adc_score_blocks", "route": "cuda",
                 "source": "src/repro_torch/csrc/adc.cu",
                 "replaces": "src/repro/kernels/adc/kernel.py:79",
                 "launches": launches["adc_score_blocks"],
                 "max_abs_err": (out - ref).abs().max().item(),
                 "ms": cuda_ms(lambda: adc_score_blocks(lut, codes, sel), 20),
                 "plain_ms": cuda_ms(
                     lambda: adc_score_blocks_ref(lut, codes, sel), 3),
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                 "shapes": [tuple(lut.shape), (U, cap, nsub), (B, S),
                            f"{n_read} blocks read"]})

    # lstm_sequence: the batch's Stage-I features through the selector
    x = inputs["feats"]
    w = {k: p.detach() for k, p in selector.named_parameters()}
    (B, n, F), (H, G) = x.shape, w["wh"].shape
    out = lstm_sequence(x, w["wx"], w["wh"], w["b"])
    ref = lstm_sequence_ref(x, w["wx"], w["wh"], w["b"])
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"lstm_sequence disagrees with plain: {err}")
    lstm = torch.nn.LSTM(F, H, batch_first=True).to(dev)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w["wx"].T)
        lstm.weight_hh_l0.copy_(w["wh"].T)
        lstm.bias_ih_l0.copy_(w["b"])
        lstm.bias_hh_l0.zero_()
        lib_err = (lstm(x)[0] - ref).abs().max().item()
        lib_ms = cuda_ms(lambda: lstm(x), 50)
    b_ms, b_by = bound(4 * (x.numel() + F * G + H * G + G + B * n * H),
                       2 * B * n * G * (F + H))
    rows.append({"name": "lstm_sequence", "route": "cuda",
                 "source": "src/repro_torch/csrc/lstm.cu",
                 "replaces": "src/repro/kernels/lstm/kernel.py:46",
                 "launches": launches["lstm_sequence"], "max_abs_err": err,
                 "ms": cuda_ms(lambda: lstm_sequence(
                     x, w["wx"], w["wh"], w["b"]), 50),
                 "plain_ms": cuda_ms(lambda: lstm_sequence_ref(
                     x, w["wx"], w["wh"], w["b"]), 10),
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                 "shapes": [(B, n, F), (F, G), (H, G), (G,)],
                 "library_max_abs_err": lib_err})
    for r in rows:
        print(f"  {r['name']}: kernel_ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} library_ms {r['library_ms']} bound_ms "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) launches "
              f"{r['launches']} max_abs_err {r['max_abs_err']:.3g} shapes "
              f"{r['shapes']}", flush=True)
    return rows


def isolated_ranks(scores, tol):
    """Ranks more than `tol` from both neighbours' scores (the last rank's
    next neighbour is unseen, so it is left out)."""
    s = np.asarray(scores, np.float64)
    gap = np.abs(s[:, :-1] - s[:, 1:])
    ok = np.zeros(s.shape, bool)
    ok[:, :-1] = gap > tol
    ok[:, 1:-1] &= gap[:, :-1] > tol
    return ok


def build_state(cfg, dev, tmp, n_queries):
    """Corpus, queries, index, PQ, code shards and an untrained selector,
    built by the port on `dev`. Returns (index, store, pq, queries)."""
    from repro_torch.core.clusd import build_index
    from repro_torch.core.features import feature_dim
    from repro_torch.core.lstm import LSTMSelector
    from repro_torch.core.quant import train_pq
    from repro_torch.data import synth_corpus, synth_queries
    from repro_torch.engine import ShardedPQStore
    from repro_torch.index import write_code_shards

    g = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    corpus = synth_corpus(SEED, cfg.n_docs, cfg.dim, cfg.vocab,
                          topic_noise=0.5)
    qs = synth_queries(SEED + 1, corpus, n_queries)
    print(f"  synthetic corpus + queries: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    index = build_index(cfg, corpus.embeddings, corpus.doc_terms,
                        corpus.doc_weights, generator=g, device=dev)
    sync(dev)
    fill = (index.cluster_docs >= 0).sum(1)
    print(f"  index (kmeans, cluster table, neighbor graph, sparse index): "
          f"{time.perf_counter() - t0:.2f} s; cluster fill min "
          f"{fill.min().item()} max {fill.max().item()}; postings "
          f"{tuple(index.sparse_index.postings_docs.shape)}")
    t0 = time.perf_counter()
    nsub = min(NSUB, cfg.dim)
    pq = train_pq(corpus.embeddings, nsub, sample_docs=1 << 16, generator=g,
                  device=dev)
    sync(dev)
    print(f"  PQ nsub {nsub} train (sample of up to 65536 docs) + encode: "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cd = index.cluster_docs.cpu().numpy()
    paths, ranges = write_code_shards(tmp, pq.codes.cpu().numpy(), cd,
                                      N_SHARDS)
    print(f"  {len(paths)} code shards: "
          f"{sum(os.path.getsize(p) for p in paths)} bytes, "
          f"{time.perf_counter() - t0:.2f} s")
    digest = hashlib.sha256()
    for t in (index.centroids, index.cluster_docs, index.neighbor_ids,
              index.sparse_index.postings_docs, pq.codebooks, pq.codes):
        digest.update(t.cpu().numpy().tobytes())
    print(f"  state sha256 (centroids, cluster table, neighbor graph, "
          f"postings, PQ): {digest.hexdigest()}")
    index.selector = LSTMSelector(
        feature_dim(cfg), cfg.lstm_hidden,
        generator=torch.Generator().manual_seed(SEED)).to(dev)
    store = ShardedPQStore(paths, ranges, cfg.cluster_cap,
                           pq.codebooks.cpu().numpy(), cd)
    return index, store, pq, qs


def serve(cfg, index, store, qs, dev):
    """Serve every query through RetrievalEngine with the launch counts
    zeroed just before; check the results. Returns the launch counts."""
    from repro_torch import kernels
    from repro_torch.core import sparse as sparse_lib
    from repro_torch.data import mrr_at
    from repro_torch.engine import RetrievalEngine

    n = len(qs.rel_doc)
    kernels.reset_launches()
    with RetrievalEngine(cfg, index, store, max_batch=MAX_BATCH,
                         trace_sample_rate=1.0, device=dev) as eng:
        t0 = time.perf_counter()
        ids, scores = eng.retrieve(qs.q_dense, qs.q_terms, qs.q_weights)
        sync(dev)
        wall = time.perf_counter() - t0
        stats = eng.stats()
        spans = [{sp.name: round(sp.dur_ms, 3) for sp in tr.spans}
                 for tr in eng.tracer.traces]
    launches = dict(kernels.LAUNCHES)
    print(f"  kernel launches: {launches}")
    if stats["prefetch_errors"]:
        raise AssertionError(f"{stats['prefetch_errors']} prefetch fetches "
                             "failed")
    ids_np, sc_np = ids.cpu().numpy(), scores.cpu().numpy()
    if ids_np.shape != (n, cfg.k_final) or not np.isfinite(sc_np).all() \
            or (np.diff(sc_np, axis=1) > 0).any() \
            or ids_np.min() < 0 or ids_np.max() >= cfg.n_docs:
        raise AssertionError("served results malformed")
    sparse_ids = torch.cat([sparse_lib.sparse_retrieve_topk(
        index.sparse_index,
        torch.from_numpy(qs.q_terms[lo:lo + MAX_BATCH]).to(dev),
        torch.from_numpy(qs.q_weights[lo:lo + MAX_BATCH]).to(dev),
        cfg.k_final)[0] for lo in range(0, n, MAX_BATCH)])
    print(f"  wall {wall:.3f} s for {n} queries")
    print(f"  stats: {json.dumps(stats)}")
    for i, sp in enumerate(spans):
        print(f"  batch {i} spans (ms): {json.dumps(sp)}")
    print(f"  MRR@10 {mrr_at(ids_np, qs.rel_doc):.4f}; sparse-only MRR@10 "
          f"{mrr_at(sparse_ids.cpu().numpy(), qs.rel_doc):.4f} (untrained "
          f"selector; for information)")
    return launches


def parity(cfg, index, store, qs, dev):
    """The first PARITY_QUERIES queries served on `dev` and on the CPU."""
    from repro_torch.engine import RetrievalEngine

    sl = slice(0, PARITY_QUERIES)
    q3 = (qs.q_dense[sl], qs.q_terms[sl], qs.q_weights[sl])
    with RetrievalEngine(cfg, index, store, max_batch=MAX_BATCH,
                         prefetch=False, device=dev) as eng:
        g_ids, g_sc = (t.cpu().numpy() for t in eng.retrieve(*q3))
    with RetrievalEngine(cfg, index.to("cpu"), store, max_batch=MAX_BATCH,
                         prefetch=False, device="cpu") as eng:
        c_ids, c_sc = (t.numpy() for t in eng.retrieve(*q3))
    ok = isolated_ranks(c_sc, PARITY_GAP)
    bad = int((g_ids[ok] != c_ids[ok]).sum())
    close = np.allclose(g_sc, c_sc, rtol=1e-5, atol=0)
    print(f"  ranks compared {int(ok.sum())} of {ok.size}; id mismatches "
          f"{bad}; scores allclose(rtol 1e-5) {close}; max |score diff| "
          f"{np.abs(g_sc - c_sc).max():.3g}")
    if bad or not close:
        raise AssertionError("card and CPU disagree")


def profile_batch(cfg, index, store, qs, dev):
    """torch.profiler over one steady batch of MAX_BATCH queries (after a
    warm-up batch on a fresh engine): device busy share of the batch's
    wall time and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import RetrievalEngine

    q3 = [(x[:MAX_BATCH], x[MAX_BATCH:2 * MAX_BATCH])
          for x in (qs.q_dense, qs.q_terms, qs.q_weights)]
    with RetrievalEngine(cfg, index, store, max_batch=MAX_BATCH,
                         device=dev) as eng:
        eng.retrieve(*(w for w, _ in q3))
        sync(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.retrieve(*(b for _, b in q3))
            sync(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
    dev_rows, cpu_rows = [], []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            dev_rows.append((dev_us / 1e3, ev.count, ev.key))
        else:
            cpu_rows.append((ev.self_cpu_time_total / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in dev_rows)
    print(f"  batch wall {wall_ms:.3f} ms (profiled); device busy "
          f"{busy:.3f} ms; idle share {1 - busy / wall_ms:.3f}")
    print("  device time by kernel / copy:")
    for ms, count, key in sorted(dev_rows, reverse=True)[:12]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    print("  host (self CPU) time by op:")
    for ms, count, key in sorted(cpu_rows, reverse=True)[:10]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    from repro_torch.configs import clusd_msmarco
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        kind = torch.cuda.get_device_name(0)
        print(f"nvidia-smi: {smi}")
        print(f"torch: {torch.__version__} cuda {torch.version.cuda} "
              f"device {kind} x{torch.cuda.device_count()}")

    with phase("kernel build (nvcc, sm_90a)"):
        for name, log in build.build_all().items():
            print(f"--- {name}.cu: {log['seconds']:.2f} s -> {log['so']}")
            print(log["ptxas"].strip())

    cfg = dataclasses.replace(clusd_msmarco.full(), n_docs=N_DOCS)
    print(f"config: dim {cfg.dim} N {cfg.n_clusters} cap {cfg.cluster_cap} "
          f"vocab {cfg.vocab} max_postings {cfg.max_postings} k_sparse "
          f"{cfg.k_sparse} bins {cfg.bins} n {cfg.n_candidates} H "
          f"{cfg.lstm_hidden} m {cfg.n_neighbors} u {cfg.u_bins} theta "
          f"{cfg.theta} max_selected {cfg.max_selected} k_final "
          f"{cfg.k_final} fusion {cfg.fusion} n_docs {cfg.n_docs} "
          f"nsub {NSUB}")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="chip_smoke_") as tmp:
        with phase("state build"):
            index, store, pq, qs = build_state(cfg, dev, tmp, N_QUERIES)
            print(f"  device memory: {torch.cuda.memory_allocated() / 1e9:.2f}"
                  f" GB allocated, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        with phase(f"serving {N_QUERIES} queries"):
            launches = serve(cfg, index, store, qs, dev)
            if min(launches.values()) <= 0:
                raise AssertionError(f"a kernel of the main path never "
                                     f"launched: {launches}")
        with phase("profile of one steady batch"):
            profile_batch(cfg, index, store, qs, dev)
        with phase("kernels vs plain versions on main-path inputs"):
            inputs = main_path_inputs(cfg, index, store, qs, dev)
            rows = check_kernels(dev, launches, inputs, pq, index.selector)
        with phase(f"parity: {PARITY_QUERIES} queries, card vs CPU"):
            parity(cfg, index, store, qs, dev)

    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k not in ("shapes",
                                                "library_max_abs_err")}
                                  for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
