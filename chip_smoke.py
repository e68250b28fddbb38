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
     port's own build side; a sha256 of the built state shows that one
     seed builds one state;
  4. two index directories written by the port's `write_index`: v2 (PQ
     code shards, 8 shards) and v1 (float32 blocks at the full widths,
     8 shards, 6.4 GB, with the PQ under pq/), and one DiskClusterStore
     file of the same float32 blocks (`DiskClusterStore.pack`, 6.4 GB);
  5. device stores: `RetrievalEngine(cfg, index)` with no store serves
     the 1024 queries in batches of 256 from an InMemoryStore (the
     index's float embeddings and their 6.4 GB (N, cap, dim) block
     table, the cluster_score kernel), then from a PQStore (the index's
     PQ and its (N, cap, nsub) code table, the ADC kernels), each with
     one profiled batch and the card-vs-CPU parity on 16 queries (and
     cluster_score held to its plain version on one more InMemoryStore
     batch's input, the whole table by cluster id); the
     PQStore engine's last batch gives the topk and bin_overlap kernels
     their main-path inputs; then one batch through `clusd.retrieve`
     with each of the "rnn" and "mlp" selectors (seeded params), card
     against CPU; then DiskStore serving: `RetrievalEngine(cfg, index,
     store=DiskStore(...))` answers the 1024 queries from the block file
     through the block cache and the "dot" tail (cluster_score), with one
     profiled batch and card-vs-CPU parity on 16 queries;
  6. v2 serving: `IndexReader.open(v2, verify="size").engine()` answers
     the 1024 queries, then torch.profiler over one more steady batch;
  7. v1 serving: the same 1024 queries through the v1 directory — the
     "dot" tail and the cluster_score kernel, about 4 GB of unique float
     blocks per batch — then one profiled batch;
  8. reloads: `reload_index()` on the v1 engine while a second thread
     keeps serving (0 failed batches, reloads 1, cache cleared, I/O
     counters kept, ids equal to a fresh engine's), then
     `reload_selector()` (the cache is kept); then the v1 directory with
     its quantizer: `RetrievalEngine(*IndexReader.open(v1).load_index())`
     serves the 1024 queries from the device PQStore (the ADC kernels),
     with card-vs-CPU parity on 16;
  9. recsys: wide_deep full (configs/wide_deep.py `full()`: 40 fields,
     embed_dim 32, mlp 1024-512-256): its fused tables (22,372,352 padded
     rows, 2.86 GB, and the 89.5 MB wide table) filled on the card from a
     torch.Generator; `make_serve_step` over RecsysStream batches of 512
     (the serve_p99 shape) and 262,144 (serve_bulk); a CluSD candidate
     index of 1M items from `candidate_tower` (k-means into 4096
     clusters of 256 slots, the cluster table and neighbour graph); 64
     queries, one at a time, through `clusd_candidate_retrieval` beside
     `brute_force_retrieval` (their top-100 overlap for information);
     card-vs-CPU parity of logits on 16 rows and of retrieval ids on 4
     queries;
 10. each kernel against its plain version on the inputs the engines'
     own stage functions (and the recsys phase) make, timed with CUDA
     events beside one PyTorch call of the same function where there is
     one, and its bound (adc_score_blocks on the v2 and the PQStore
     batch's inputs with its gather floor beside, lstm_sequence and
     nn.LSTM on the v2 batch's features and a recsys query's,
     bin_overlap on the Stage-I batch's results and a recsys query's,
     embedding_bag on the four recsys bags with its sector floor, topk
     also on the neighbor graph's (8192, 8192) similarities, k 128), and
     cluster_score's grouping check: (query, block) pairs scored in groups
     of 1, 3, 64 and 512 queries must be bitwise equal;
 11. embedding_bag's per-call error word: two threads on their own
     streams, one with a bad index, 200 bags each (only that one raises,
     the other's bags are bitwise), and the word's zero fill timed;
 12. the update paths (the corpus embeddings were staged to a file
     after the state build):
     a. `build_index_offline` over an np.memmap of that file in shards of
        2^17 rows (one shard on the card at a time), its spans and peak
        device memory gated below the bound derived in `offline_phase`
        (beside the in-RAM build_index's peak), every doc in the cluster
        table once; `write_index` v2 from the memmap training its PQ
        (`train_pq_stream`, nsub 96), one batch of 256 served from it;
     b. `repro_torch.launch.update_index.main` in process on the card
        over the v2 directory: 10000 upserts and 5000 deletes (`synth_delta`,
        seed 0), 1024 queries before and after a hot reload, a compacted
        copy's parity; the same delta committed on the CPU to a copy must
        give the same files (upsert codes may differ only at near-ties);
     c. a re-clustering delta (seed 1, thresholds 0) on the v1 directory
        committed on the card while a second thread serves two batches,
        `reload_index()` to generation 1 (ids equal a fresh engine's, no
        deleted id served, the neighbor graph equal a CPU one), then
        `compact_index` in place, a full verify and `reload_index()` to
        generation 2 (ids equal generation 1's);
 13. the train path, on the v2 directory as 12b left it (generation 1,
     tombstones): the label pass (512 train and 128 holdout queries of
     the directory's corpus recipe, streamed in chunks of 64 clusters
     through a store that refuses a larger fetch, scored on the card)
     saved into the label cache; `repro_torch.launch.train_selector.main`
     in process on the card with the config's 150 epochs, a checkpoint
     every third of the steps, `--publish --serve-check 256` while a
     second engine serves beside it and hot-reloads the new generation
     (0 failed batches, its ids equal a fresh engine's), then again with
     `--resume` (both label sets from the cache, no steps left); the
     build_index CLI at its defaults (20000 docs, dim 64, 256 clusters,
     512 train queries, 40 epochs), served by the port's reader; recsys
     `make_train_step` on wide_deep `full()`, 8 steps of 512. Then the
     gates: the streamed dense ids against the in-RAM top-k over the
     store's decoded matrix on the card (isolated ranks), no deleted doc
     among them, 16 queries again on the CPU; one step's gradients and
     the first 20 steps' losses card against CPU; k steps, resume, N - k
     against N straight on the card (bitwise); the engine's Stage II on
     the holdout against `select_at` on the calibration probabilities;
     one recsys step at smoke() widths card against CPU; MRR@10 before
     and after the publish; then lstm_sequence at the trainer's largest
     bucket (its backward bitwise autograd through the plain version),
     cluster_score at the label chunk (beside q @ blocks^T), topk over the
     (128, n_docs) full-dense rows with k 10, and the embedding_bag
     backward, each against its plain version (the wide bag's forward
     and forward + backward beside F.embedding_bag's, with their bounds);
 14. the distributed path (it runs right after phase 11, while the
     staged embeddings file is still there): `make_serve_step` through
     `ServeRunner` on a 1 x 4 mesh, 4 processes (torch.multiprocessing,
     spawn) on the one card in a gloo group (the gathers staged through
     host memory), each building its 1.6 GB slice of the blocked index
     from the staged embeddings file; 256 queries, 3 timed steps; gates:
     the ranks agree, each rank's card output against its CPU twin on 16
     queries, overlap@10 with the single-host `clusd.retrieve` (computed
     in phase 5 beside the same step run as one rank, printed for
     information) above 0.9, and the recsys guide row's top-k with
     `local_topk` equal to the global one; rank 0 then holds cluster_score
     to its plain version on its own input while the others wait;
 15. the router path: `repro_torch.launch.serve.main` in process
     over v2 as the train path left it (`--hosts 4 --replication 2
     --kill-host 1 --check-parity --metrics-port 0`, its /healthz and
     /metrics scraped while it serves, every host's lane in its Chrome
     trace); then over v2 at 4 hosts, R 1 and R 2, the 1024 queries
     bitwise a single-host engine (R 2 twice, the second pass traced:
     p50/p99, qps, per-host counts and hit rates, span shares), one v1
     batch through "dot" hosts bitwise, R 1 with a host killed bitwise a
     placement without its shards, and a rolling `reload_index` across a
     generation committed by `write_index_delta` while a second thread
     serves; then one host's `adc_score_blocks`, one "dot" host's
     `cluster_score` and the distributed merge top-k against their plain
     versions;
 16. parity: the same 16 queries served on the card and on the CPU
     (plain versions) through each (updated) directory must agree; v2
     now serves the trained selector.

Every kernel's launch count is zeroed just before each serving path and
read just after it; each path must have launched each kernel it runs
(topk and bin_overlap on all thirteen, embedding_bag on recsys and
train), and the kernel table sums the thirteen paths (the seven serving
paths, the offline build, the two updates, the train path, the
distributed ranks and the router). Prints the kernel table as one JSON
line, the nvidia-smi line, and last {"ok": true, "device": {...}}. Any
failure exits non-zero; without a card it exits 2 before doing anything.
"""

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
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
# recsys phase: wide_deep full(), the serve_p99 and serve_bulk batch
# sizes (timed batches of each) and the retrieval_cand shape
RECSYS_SIZE = "full"
RECSYS_SERVE_BATCHES = {512: 32, 262144: 6}
RECSYS_CANDIDATES = 1_000_000      # in N 4096 clusters x cap 256 slots
RECSYS_CLUSTERS, RECSYS_CAP = 4096, 256
RECSYS_QUERIES = 64
RECSYS_PARITY_ROWS, RECSYS_PARITY_QUERIES = 16, 4
# update phases: the offline build's shard, the deltas' churn (about 1 %
# of the 2^20 docs), the PQ writer's read chunk
OFFLINE_SHARD_DOCS = 1 << 17
UPDATE_UPSERTS, UPDATE_DELETES = 10000, 5000
PQ_CHUNK_DOCS = 1 << 14
BUILD_INDEX_PEAK = 0               # the in-RAM build_index's, set on the card
# the train path: the CLI's query counts and label chunk, the serve check,
# the recsys steps; card-vs-CPU tolerances of a step's gradients, and of
# the first 20 steps' losses (Adam moves each parameter by about lr
# whatever its gradient's size, so near-zero gradients that differ in
# sign between the devices move parameters apart by up to 2 lr a step)
TRAIN_QUERIES, HOLDOUT_QUERIES, TRAIN_CHUNK = 512, 128, 64
TRAIN_SERVE_CHECK, TRAIN_RECSYS_STEPS = 256, 8
TRAIN_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-3
# the distributed path: ranks on the one card, queries, the CPU twin's
# queries, timed steps; the router path: the CLI's sustained serving
# (its endpoint is scraped meanwhile), the rolling reload's delta
DIST_RANKS, DIST_QUERIES, DIST_PARITY_QUERIES, DIST_REPS = 4, 256, 16, 3
ROUTER_SERVE_SECONDS = 3
ROUTER_UPSERTS, ROUTER_DELETES = 2000, 1000
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
    """Mean milliseconds of fn() on the card, by CUDA events around eager
    calls (the host's Python overhead included where it is the longer)."""
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


def graph_ms(fn, reps=20):
    """Mean milliseconds of fn() on the card, replayed from one CUDA graph
    of `reps` calls: the device's time for the work, without the host's
    Python overhead between launches. fn must not sync with the host."""
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


def bound(nbytes, flops):
    """(ms, "bytes"|"operations"): the least time for this work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def table_sectors(table, idx):
    """The distinct 32-byte sectors of `table`'s memory that the rows idx
    picks span: what its reads move at least, where a row is narrower
    than a sector."""
    row_bytes = table.shape[1] * table.element_size()
    base = table.data_ptr() % 32
    u = torch.unique(idx).long()
    start = (base + u * row_bytes) // 32
    end = (base + (u + 1) * row_bytes - 1) // 32
    return int((end - start + 1).sum() - (start[1:] == end[:-1]).sum())


def gathered_einsum(q, blocks, sel):
    """cluster_score's library yardstick where no one call computes it:
    torch.einsum over the gathered blocks, B in chunks of 32."""
    return lambda: torch.cat([torch.einsum(
        "bd,bscd->bsc", q[i:i + 32], blocks[sel[i:i + 32].long()])
        for i in range(0, q.shape[0], 32)])


def cluster_score_case(key, q, blocks, sel, library):
    """cluster_score on one main-path shape against its plain version
    (rtol 1e-5, atol 1e-6 on unit-norm rows: the kernel's one FMA chain
    against the einsum's order; raises), with the kernel's and
    `library`'s ms (CUDA-graph replays), the plain version's (eager) and
    the bound: the unique blocks `sel` reaches, the queries, `sel` and
    the scores over 3.35 TB/s, or 2 B S cap dim FLOP over 67 TFLOP/s.
    Returns {"note", "ms", "plain_ms", "library_ms", "bound_ms",
    "bound_by", "max_abs_err"}."""
    from repro_torch.kernels.cluster_score import (cluster_score,
                                                   cluster_score_ref)

    U, cap, dim = blocks.shape
    B, S = sel.shape
    out = cluster_score(q, blocks, sel)
    ref = cluster_score_ref(q, blocks, sel)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not torch.allclose(out, ref, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"cluster_score at the {key} shape disagrees "
                             f"with plain: {err}")
    del out, ref
    n_read = torch.unique(sel).numel()
    b_ms, b_by = bound(4 * (n_read * cap * dim + B * dim + B * S * cap)
                       + 4 * B * S, 2 * B * S * cap * dim)
    t = {"ms": graph_ms(lambda: cluster_score(q, blocks, sel)),
         "plain_ms": cuda_ms(lambda: cluster_score_ref(q, blocks, sel), 3,
                             warmup=1),
         "library_ms": graph_ms(library, 3),
         "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
    t["note"] = (f"{key} q {(B, dim)} blocks {(U, cap, dim)} sel {(B, S)}, "
                 f"{n_read} blocks read: ms {t['ms']:.4f} plain "
                 f"{t['plain_ms']:.4f} library {t['library_ms']:.4f} bound "
                 f"{b_ms:.4f} ({b_by}); max_abs_err {err:.3g}")
    return t


def cluster_score_groups(dev):
    """The same (query, block) pairs scored inside groups of 1, 3, 64 and
    512 queries at the full widths (the bytes path for 1 and 3, GEMM
    tiles of 64 and four of 128 above), every other query alone on a
    block of its own; raises unless each pair scores bitwise the same in
    every group it is in. Returns a note."""
    from repro_torch.kernels.cluster_score import cluster_score

    B, cap, dim = 512, 256, 768
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn(B, dim, device=dev, generator=g)
    q /= q.norm(dim=1, keepdim=True)
    blocks = torch.randn(B + 1, cap, dim, device=dev, generator=g)
    blocks /= blocks.norm(dim=2, keepdim=True)
    outs = {}
    for n in (1, 3, 64, 512):
        sel = torch.arange(1, B + 1, dtype=torch.int32,
                           device=dev)[:, None].contiguous()
        sel[:n] = 0
        outs[n] = cluster_score(q, blocks, sel)[:, 0].view(torch.int32)
    torch.cuda.synchronize()
    bad = [(a, b) for a in outs for b in outs
           if a < b and not torch.equal(outs[a][:a], outs[b][:a])]
    if bad:
        raise AssertionError(f"cluster_score: a (query, block) pair scores "
                             f"differently in groups {bad}")
    return ("grouping: (query, block 0) pairs in groups of 1, 3, 64 and "
            "512 queries bitwise equal")


def ptxas_summary(text):
    """One line per compiled kernel from nvcc's -Xptxas -v output: its name
    (with bfloat16 marked), registers, barriers, shared memory, spills."""
    out, name = [], None
    for ln in text.splitlines():
        if "Compiling entry" in ln:
            m = re.search(r"\d+([A-Za-z_]*kernel\w*?)(?:I|E|P)", ln)
            name = (m.group(1) if m else ln.split("'")[1][:60]) \
                + ("<bf16>" if "bfloat16" in ln else "")
        elif "spill" in ln and name:
            spill = "spill stores/loads " + "/".join(
                re.findall(r"(\d+) bytes spill", ln)) + " B"
        elif "Used" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def isolated_ranks(scores, tol):
    """Ranks more than `tol` from both neighbours' scores (the last rank's
    next neighbour is unseen, so it is left out)."""
    s = np.asarray(scores, np.float64)
    gap = np.abs(s[:, :-1] - s[:, 1:])
    ok = np.zeros(s.shape, bool)
    ok[:, :-1] = gap > tol
    ok[:, 1:-1] &= gap[:, :-1] > tol
    return ok


def queries(qs, lo, hi):
    return qs.q_dense[lo:hi], qs.q_terms[lo:hi], qs.q_weights[lo:hi]


def build_state(cfg, dev, n_queries):
    """Corpus, queries, index, PQ and an untrained selector, built by the
    port on `dev`. Returns (index, pq, corpus, queries)."""
    from repro_torch.core.clusd import build_index
    from repro_torch.core.features import feature_dim
    from repro_torch.core.lstm import LSTMSelector
    from repro_torch.core.quant import train_pq
    from repro_torch.data import synth_corpus, synth_queries

    g = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    corpus = synth_corpus(SEED, cfg.n_docs, cfg.dim, cfg.vocab,
                          topic_noise=0.5)
    qs = synth_queries(SEED + 1, corpus, n_queries)
    print(f"  synthetic corpus + queries: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    index = build_index(cfg, corpus.embeddings, corpus.doc_terms,
                        corpus.doc_weights, generator=g, device=dev)
    sync(dev)
    global BUILD_INDEX_PEAK
    BUILD_INDEX_PEAK = torch.cuda.max_memory_allocated() if on_card else 0
    fill = (index.cluster_docs >= 0).sum(1)
    print(f"  index (kmeans, cluster table, neighbor graph, sparse index): "
          f"{time.perf_counter() - t0:.2f} s; cluster fill min "
          f"{fill.min().item()} max {fill.max().item()}; postings "
          f"{tuple(index.sparse_index.postings_docs.shape)}; peak device "
          f"memory {BUILD_INDEX_PEAK / 1e9:.3f} GB")
    t0 = time.perf_counter()
    nsub = min(NSUB, cfg.dim)
    pq = train_pq(corpus.embeddings, nsub, sample_docs=1 << 16, generator=g,
                  device=dev)
    sync(dev)
    print(f"  PQ nsub {nsub} train (sample of up to 65536 docs) + encode: "
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
    return index, pq, corpus, qs


def write_dirs(cfg, index, pq, corpus, tmp):
    """The v2 and v1 (float32 blocks, and the PQ under pq/) index
    directories, by the port's writer, and the DiskClusterStore file of
    the same blocks. Returns ({"v2", "v1"}: path, the block store)."""
    from repro_torch.core.disk import DiskClusterStore
    from repro_torch.index import write_index

    out = {}
    for name, kw in (("v2", dict(format_version=2, pq=pq)),
                     ("v1", dict(format_version=1, block_dtype="float32"))):
        t0 = time.perf_counter()
        out[name] = os.path.join(tmp, name)
        index.quantizer = pq if name == "v1" else None   # v1 writes pq/
        man = write_index(out[name], cfg, index, corpus.embeddings,
                          n_shards=N_SHARDS, extra=corpus_extra(cfg), **kw)
        index.quantizer = None
        shards = sum(man["files"][s["file"]]["bytes"]
                     for s in man["block_shards"])
        print(f"  {name}: {man['total_bytes']} bytes ({shards} in "
              f"{len(man['block_shards'])} block shards; pq/ "
              f"{man['pq'] is not None}), {time.perf_counter() - t0:.2f} s",
              flush=True)
    t0 = time.perf_counter()
    blocks = DiskClusterStore.pack(os.path.join(tmp, "blocks.bin"),
                                   corpus.embeddings, index.cluster_docs)
    print(f"  DiskClusterStore.pack: {os.path.getsize(blocks.path)} bytes "
          f"({blocks.n_clusters} x {blocks.cap} x {blocks.dim} float32) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return out, blocks


def corpus_extra(cfg):
    """The synthetic-corpus recipe a directory carries under `extra`, from
    which the update CLI regenerates queries."""
    return {"corpus": {"kind": "synthetic", "seed": SEED,
                       "n_docs": cfg.n_docs, "dim": cfg.dim,
                       "vocab": cfg.vocab}}


def check_results(cfg, ids, scores, n):
    ids_np, sc_np = ids.cpu().numpy(), scores.cpu().numpy()
    if ids_np.shape != (n, cfg.k_final) or not np.isfinite(sc_np).all() \
            or (np.diff(sc_np, axis=1) > 0).any() \
            or ids_np.min() < 0 or ids_np.max() >= cfg.n_docs:
        raise AssertionError("served results malformed")
    return ids_np


def serve_engine(name, eng, qs, n, dev):
    """Serve the first n queries through `eng` with the launch counts
    zeroed just before and read just after; check the results; print the
    stats and spans; profile one more steady batch. Returns the launch
    counts of the run."""
    from repro_torch import kernels
    from repro_torch.core import sparse as sparse_lib
    from repro_torch.data import mrr_at

    kernels.reset_launches()
    t0 = time.perf_counter()
    ids, scores = eng.retrieve(*queries(qs, 0, n))
    sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    stats = eng.stats()
    print(f"  {name} kernel launches: {launches}")
    if stats["prefetch_errors"]:
        raise AssertionError(f"{stats['prefetch_errors']} prefetch fetches "
                             "failed")
    cfg = eng.cfg
    ids_np = check_results(cfg, ids, scores, n)
    sparse_ids = torch.cat([sparse_lib.sparse_retrieve_topk(
        eng.index.sparse_index,
        torch.from_numpy(qs.q_terms[lo:lo + MAX_BATCH]).to(dev),
        torch.from_numpy(qs.q_weights[lo:lo + MAX_BATCH]).to(dev),
        cfg.k_final)[0] for lo in range(0, n, MAX_BATCH)])
    print(f"  wall {wall:.3f} s for {n} queries")
    print(f"  stats: {json.dumps(stats)}")
    for i, tr in enumerate(eng.tracer.traces):
        print(f"  batch {i} spans (ms): "
              f"{json.dumps({sp.name: round(sp.dur_ms, 3) for sp in tr.spans})}")
    print(f"  MRR@10 {mrr_at(ids_np, qs.rel_doc[:n]):.4f}; sparse-only "
          f"MRR@10 {mrr_at(sparse_ids.cpu().numpy(), qs.rel_doc[:n]):.4f} "
          f"(untrained selector; for information)")
    profile_batch(eng, queries(qs, n - MAX_BATCH, n), dev)
    return launches


def serve_path(name, path, qs, n, dev):
    """serve_engine over IndexReader.open(path).engine(). Returns
    (launches, engine): the engine stays open for the caller."""
    from repro_torch.index import IndexReader

    t0 = time.perf_counter()
    eng = IndexReader.open(path, verify="size").engine(
        max_batch=MAX_BATCH, trace_sample_rate=1.0, device=dev)
    print(f"  open + load_index: {time.perf_counter() - t0:.2f} s; "
          f"store {type(eng.store).__name__}, use_adc {eng.use_adc}")
    return serve_engine(name, eng, qs, n, dev), eng


def serve_device(name, cfg, index, qs, n, dev):
    """serve_engine over RetrievalEngine(cfg, index): no store given, so
    the engine builds the index's default device store. Returns
    (launches, engine)."""
    from repro_torch.engine import RetrievalEngine

    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = RetrievalEngine(cfg, index, max_batch=MAX_BATCH,
                          trace_sample_rate=1.0, device=dev)
    sync(dev)
    table = eng.store.code_blocks if eng.store.is_coded else eng.store.blocks
    print(f"  engine + store: {time.perf_counter() - t0:.2f} s; store "
          f"{type(eng.store).__name__}, block table "
          f"{tuple(table.shape)} {table.dtype} {table.nbytes} bytes")
    launches = serve_engine(name, eng, qs, n, dev)
    if on_card:
        print(f"  device memory: {torch.cuda.memory_allocated() / 1e9:.2f} "
              f"GB allocated, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB since the "
              f"engine was made")
    return launches, eng


def memory_store_case(eng, qs):
    """cluster_score at the memory store's shape: one more batch (the last
    MAX_BATCH queries) through the InMemoryStore engine, its
    score_blocks input captured (the queries, the store's whole (N, cap,
    dim) block table, the batch's selected cluster ids), then
    cluster_score_case on it. Returns the note."""
    got, store = [], eng.store
    real = store.score_blocks
    store.score_blocks = lambda qd, sel: (got.append((qd, sel)),
                                          real(qd, sel))[1]
    try:
        eng.retrieve(*queries(qs, N_QUERIES - MAX_BATCH, N_QUERIES))
    finally:
        del store.score_blocks
    qd, sel = got[-1]
    q, sel = qd.float().contiguous(), sel.int().contiguous()
    return cluster_score_case("memory store", q, store.blocks, sel,
                              gathered_einsum(q, store.blocks, sel))["note"]


def serve_disk(cfg, index, blocks, qs, n, dev):
    """serve_engine over RetrievalEngine(cfg, index, store=DiskStore(...)):
    the paper's on-disk case, one DiskClusterStore file read through the
    engine's block cache (the v1 phase's capacity) and the "dot" tail.
    Returns (launches, engine)."""
    from repro_torch.engine import DiskStore, RetrievalEngine

    eng = RetrievalEngine(cfg, index, store=DiskStore(blocks,
                                                      index.cluster_docs),
                          max_batch=MAX_BATCH, trace_sample_rate=1.0,
                          device=dev)
    launches = serve_engine("disk", eng, qs, n, dev)
    st = eng.stats()
    print(f"  DiskStore after the {n} queries and the profiled batch: "
          f"batch p50 {st['p50_ms']} ms p99 {st['p99_ms']} ms; "
          f"io.n_ops {st['io']['n_ops']} io.bytes {st['io']['bytes']}; hit "
          f"rate {st['cache']['hit_rate']}; launches " + ", ".join(
              f"{k} {launches[k]}" for k in PATH_KERNELS["disk"]))
    return launches, eng


def serve_v1_pq(path, qs, n, dev):
    """serve_engine over RetrievalEngine(*IndexReader.open(v1).load_index()):
    the v1 directory's quantizer (pq/) on the card, served from the device
    PQStore by the ADC kernels. Returns (launches, engine)."""
    from repro_torch.engine import RetrievalEngine
    from repro_torch.index import IndexReader

    t0 = time.perf_counter()
    eng = RetrievalEngine(*IndexReader.open(path).load_index(device=dev),
                          max_batch=MAX_BATCH, trace_sample_rate=1.0,
                          device=dev)
    sync(dev)
    print(f"  open + load_index (with the quantizer) + engine: "
          f"{time.perf_counter() - t0:.2f} s; store "
          f"{type(eng.store).__name__}, code table "
          f"{tuple(eng.store.code_blocks.shape)}")
    return serve_engine("v1_pq", eng, qs, n, dev), eng


def selector_batches(cfg, index, qs, dev):
    """One batch of MAX_BATCH queries through clusd.retrieve with each of
    the "rnn" and "mlp" selectors (params from a seeded torch.Generator)
    over the index's PQStore on the card, against the first
    PARITY_QUERIES of it on the CPU. theta is the card's median
    probability; rows with a probability within 1e-5 of it are left out
    of the selection and id checks."""
    from repro_torch.core import clusd as clusd_lib
    from repro_torch.core import sparse as sparse_lib
    from repro_torch.core.features import feature_dim
    from repro_torch.core.lstm import SELECTORS

    cpu_index = index.to("cpu")
    n = PARITY_QUERIES
    q3 = queries(qs, 0, MAX_BATCH)
    for name in ("rnn", "mlp"):
        mod = SELECTORS[name](feature_dim(cfg), cfg.lstm_hidden,
                              generator=torch.Generator().manual_seed(SEED))
        params = {k: p.detach().numpy() for k, p in mod.named_parameters()}
        out = {}
        for key, d, idx, m in (("card", dev, index, MAX_BATCH),
                               ("cpu", "cpu", cpu_index, n)):
            args = [torch.from_numpy(np.ascontiguousarray(x[:m])).to(d)
                    for x in q3]
            with torch.no_grad():
                if "theta" not in out:
                    s1 = clusd_lib.select_clusters(
                        cfg, idx, args[0], *sparse_lib.sparse_retrieve_topk(
                            idx.sparse_index, args[1], args[2],
                            cfg.k_sparse),
                        selector=name, selector_params=params)
                    out["theta"] = float(s1["probs"].median())
                t0 = time.perf_counter()
                ids, scores, diag = clusd_lib.retrieve(
                    cfg, idx, *args, selector=name, theta=out["theta"],
                    selector_params=params)
                sync(d)
                out[key] = (
                    ids[:n].cpu().numpy(), scores[:n].cpu().numpy(),
                    {k: diag[k][:n].cpu().numpy()
                     for k in ("probs", "sel_ids", "sel_mask")},
                    time.perf_counter() - t0)
        g_ids, g_sc, g_d, g_s = out["card"]
        c_ids, c_sc, c_d, c_s = out["cpu"]
        p_err = float(np.abs(g_d["probs"] - c_d["probs"]).max())
        clear = (np.abs(c_d["probs"] - out["theta"]) >= 1e-5).all(axis=1)
        sel_same = all(
            np.array_equal(np.sort(g_d["sel_ids"][i][g_d["sel_mask"][i]]),
                           np.sort(c_d["sel_ids"][i][c_d["sel_mask"][i]]))
            for i in np.flatnonzero(clear))
        ok = isolated_ranks(c_sc, PARITY_GAP) & clear[:, None]
        bad = int((g_ids[ok] != c_ids[ok]).sum())
        close = np.allclose(g_sc[clear], c_sc[clear], rtol=1e-5, atol=0.0)
        print(f"  {name} selector: batch {MAX_BATCH} on the card in "
              f"{g_s:.3f} s, {n} on the CPU in {c_s:.3f} s; theta "
              f"{out['theta']:.6f}; selected mean "
              f"{g_d['sel_mask'].sum(1).mean():.2f}; probs max |diff| "
              f"{p_err:.3g}; rows clear of theta {int(clear.sum())} of {n}; "
              f"selections equal {sel_same}; id mismatches {bad} over "
              f"{int(ok.sum())} ranks; scores allclose(rtol 1e-5) {close}")
        if p_err > 1e-5 or clear.sum() < n // 2 or not sel_same or bad \
                or not close:
            raise AssertionError(f"{name} selector: card and CPU disagree")


def bag_threads(dev):
    """embedding_bag's error word is the call's own: two threads, each on
    its own stream, bag 200 times at once on the card, one with an index
    outside [0, V); only that thread raises, every time, and the other's
    outputs are bitwise the plain version's. Then the cost of the word:
    its zero fill alone, by CUDA-graph replay and eagerly, beside the
    op's eager time on the same bag."""
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_ref)

    g = torch.Generator(device=dev).manual_seed(SEED)
    V, B, hot = 100_000, 65536, 8
    table = torch.randn(V, 1, device=dev, generator=g)
    good = torch.randint(0, V, (B, hot), device=dev, generator=g,
                         dtype=torch.int32)
    bad = good.clone()
    bad[B // 3, hot // 2] = V
    ref = embedding_bag_ref(table, good)
    torch.cuda.synchronize()
    start = threading.Barrier(2)
    res = {"bad": [], "good": []}

    def run(key, idx):
        stream = torch.cuda.Stream(dev)
        start.wait()
        with torch.cuda.stream(stream):
            for _ in range(200):
                try:
                    out = embedding_bag(table, idx)
                    res[key].append(torch.equal(out.view(torch.int32),
                                                ref.view(torch.int32)))
                except IndexError as e:
                    res[key].append(str(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(k, i))
               for k, i in (("bad", bad), ("good", good))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    raised = sum(isinstance(r, str) and f"index {V} is outside" in r
                 for r in res["bad"])
    print(f"  two threads x 200 bags ({B}, {hot}, 1) on their own streams in "
          f"{time.perf_counter() - t0:.2f} s: bad thread raised {raised} of "
          f"{len(res['bad'])}; good thread bitwise "
          f"{sum(r is True for r in res['good'])} of {len(res['good'])}")
    if any(th.is_alive() for th in threads) or raised != 200 \
            or res["good"] != [True] * 200:
        raise AssertionError("embedding_bag error words crossed threads")
    def fill():
        return torch.zeros(1, dtype=torch.int64, device=dev)

    user = good[:1, :1].contiguous()
    print(f"  error word fill: graph replay {graph_ms(fill, 100):.5f} ms, "
          f"eager {cuda_ms(fill, 200):.5f} ms a call; the op on a (1, 1) "
          f"bag eager {cuda_ms(lambda: embedding_bag(table, user), 200):.5f}"
          f" ms, on ({B}, {hot}) "
          f"{cuda_ms(lambda: embedding_bag(table, good), 50):.5f} ms")


def tail_inputs(eng, qs, dev):
    """The topk, bin_overlap and adc_score_blocks kernels' inputs for the
    last batch of MAX_BATCH queries, made by the stage functions the
    device-store engine runs: the sparse score matrix (a (B, D) view of a
    (B, D + 1) buffer) and its top-k, the Stage-I overlap inputs and
    query-centroid similarities (B, N), the fused (B, n_docs) buffer (a
    view of a (B, n_docs + 1) buffer), and the ADC tail's LUT, code table
    and cluster ids."""
    from repro_torch.core import clusd as clusd_lib
    from repro_torch.core import fusion as fusion_lib
    from repro_torch.core import quant as quant_lib
    from repro_torch.core import sparse as sparse_lib
    from repro_torch.engine import pipeline as pipe_lib

    q3 = queries(qs, N_QUERIES - MAX_BATCH, N_QUERIES)
    qd = torch.tensor(q3[0], dtype=torch.float32).to(dev)
    qt = torch.tensor(q3[1], dtype=torch.int32).to(dev)
    qw = torch.tensor(q3[2], dtype=torch.float32).to(dev)
    cfg, index = eng.cfg, eng.index
    with torch.no_grad():
        sid, ss, full = sparse_lib.sparse_retrieve(index.sparse_index, qt,
                                                   qw, cfg.k_sparse)
        sel = clusd_lib.select_clusters(cfg, index, qd, sid, ss)
        did, dscore, dmask = pipe_lib.score_selected(
            eng.store, qd, sel["sel_ids"], sel["sel_mask"])
        fused = fusion_lib.fuse_buffer(
            sid, ss, did, torch.where(dmask, dscore, 0.0), dmask,
            index.n_docs, cfg.alpha, method=cfg.fusion, rrf_k=cfg.rrf_k)
        c_of = index.doc_cluster[sid.long()].int()
        norm = fusion_lib.minmax_norm(ss).float().contiguous()
        qc_sim = qd @ index.centroids.T
        # what PQStore.score_blocks hands adc_score_blocks: the batch's LUT,
        # the whole (N, cap, nsub) code table, the selected cluster ids
        pq_adc = (quant_lib.adc_tables(eng.store.pq, qd),
                  eng.store.code_blocks,
                  sel["sel_ids"].int().contiguous())
    sync(dev)
    return {"fused": fused[:, :index.n_docs], "k_final": eng.k,
            "pq_adc": pq_adc,
            "sparse": full, "k_sparse": cfg.k_sparse, "c_of": c_of,
            "qc_sim": qc_sim, "n_stage1": cfg.n_candidates,
            "n_neighbors": min(cfg.n_neighbors, index.n_clusters - 1),
            "bin_ids": index.bin_ids.int().contiguous(), "norm": norm,
            "n_clusters": index.n_clusters, "v": cfg.v_bins}


def profile_batch(eng, q3, dev):
    """torch.profiler over one steady batch on a warm engine: device busy
    share of the batch's wall time and the device time by kernel."""
    profile_call(lambda: eng.retrieve(*q3), dev, 10, 4,
                 lambda: eng.tracer.traces[-1].spans)


def profile_call(fn, dev, n_dev, n_host, spans=None):
    """torch.profiler over one call of fn: the wall time, the device busy
    time and idle share, the top n_dev device kernels / copies and the
    top n_host host ops by self time (and the spans of spans(), if
    given)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    shares = {name: sum(r[0] for r in dev_rows if name in r[2])
              for name in ("lstm", "adc_tables", "adc_score", "bin_overlap",
                           "bag_kernel", "bag_warp_kernel")}
    extra = "" if spans is None else " spans (ms) " + json.dumps(
        {sp.name: round(sp.dur_ms, 3) for sp in spans()})
    print(f"  profiled wall {wall_ms:.3f} ms; device busy {busy:.3f} ms; "
          f"idle share {1 - busy / wall_ms:.3f}; device launches "
          f"{sum(r[1] for r in dev_rows)};{extra}")
    print("  kernel shares (ms): " + ", ".join(
        f"{name} {ms:.4f} ({ms / busy:.3f})" for name, ms in shares.items()
        if ms > 0))
    print("  device time by kernel / copy:")
    for ms, count, key in sorted(dev_rows, reverse=True)[:n_dev]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    print("  host (self CPU) time by op:")
    for ms, count, key in sorted(cpu_rows, reverse=True)[:n_host]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")


def reload_phase(eng, path, qs, dev):
    """reload_index() while a second thread serves, then reload_selector()."""
    from repro_torch.index import IndexReader

    q_next = queries(qs, 0, MAX_BATCH)
    before = eng.stats()
    failures, served = [], []
    started = threading.Event()

    def serve():
        for i in range(2):
            try:
                started.set()
                eng.retrieve(*queries(qs, i * MAX_BATCH,
                                      (i + 1) * MAX_BATCH))
                served.append(i)
            except Exception as e:      # counted and raised below
                failures.append(repr(e))

    th = threading.Thread(target=serve)
    th.start()
    if not started.wait(600):
        raise AssertionError("the serving thread did not start")
    t0 = time.perf_counter()
    gen = eng.reload_index()
    reload_s = time.perf_counter() - t0
    th.join(900)
    if th.is_alive():
        raise AssertionError("the serving thread did not finish")
    ids, scores = eng.retrieve(*q_next)
    sync(dev)
    after = eng.stats()
    print(f"  reload_index -> generation {gen} in {reload_s:.2f} s beside "
          f"{len(served)} concurrent batches; failed batches "
          f"{len(failures)} {failures}")
    print(f"  reloads {after['reloads']}; cache clears "
          f"{before['cache']['clears']} -> {after['cache']['clears']}; "
          f"io.n_ops {before['io']['n_ops']} -> {after['io']['n_ops']}; "
          f"io.bytes {before['io']['bytes']} -> {after['io']['bytes']}")
    if failures or len(served) != 2 or after["reloads"] != 1 \
            or after["cache"]["clears"] <= before["cache"]["clears"] \
            or after["io"]["n_ops"] < before["io"]["n_ops"] \
            or after["io"]["bytes"] < before["io"]["bytes"]:
        raise AssertionError("reload_index under serving failed its checks")
    with IndexReader.open(path).engine(max_batch=MAX_BATCH, prefetch=False,
                                       trace_sample_rate=1.0,
                                       device=dev) as fresh:
        f_ids, f_sc = fresh.retrieve(*q_next)
        spans = {sp.name: round(sp.dur_ms, 3)
                 for sp in fresh.tracer.traces[-1].spans}
    print(f"  fresh engine without prefetch, one batch: spans (ms) "
          f"{json.dumps(spans)}")
    ok = isolated_ranks(f_sc.cpu().numpy(), PARITY_GAP)
    bad = int((ids.cpu().numpy()[ok] != f_ids.cpu().numpy()[ok]).sum())
    print(f"  reloaded vs fresh engine: id mismatches {bad} over "
          f"{int(ok.sum())} of {ok.size} ranks; max |score diff| "
          f"{(scores - f_sc).abs().max().item():.3g}")
    if bad or not torch.allclose(scores, f_sc, rtol=1e-5, atol=1e-6):
        raise AssertionError("reloaded engine disagrees with a fresh one")
    clears = after["cache"]["clears"]
    t0 = time.perf_counter()
    eng.reload_selector()
    eng.retrieve(*q_next)
    st = eng.stats()
    print(f"  reload_selector in {time.perf_counter() - t0:.2f} s (with one "
          f"batch); selector_reloads {st['selector_reloads']}; cache clears "
          f"{st['cache']['clears']}; hits {after['cache']['hits']} -> "
          f"{st['cache']['hits']}")
    if st["selector_reloads"] != 1 or st["cache"]["clears"] != clears \
            or st["cache"]["hits"] <= after["cache"]["hits"] \
            or st["prefetch_errors"]:
        raise AssertionError("reload_selector did not keep the cache")


def _no_label(batch):
    return {k: v for k, v in batch.items() if k != "label"}


def _ms_stats(ms):
    """p50, p99 and items per second of steady calls (the first left out)."""
    steady = np.asarray(ms[1:] if len(ms) > 1 else ms)
    return (float(np.percentile(steady, 50)), float(np.percentile(steady, 99)),
            steady)


def recsys_model(dev):
    """wide_deep full() on the card: its fused tables filled from a CUDA
    torch.Generator."""
    from repro_torch.configs import get_config
    from repro_torch.models import recsys as rs

    cfg = get_config("wide-deep", RECSYS_SIZE)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    model = rs.RecsysModel(cfg, rs.init_params(cfg, g, device=dev),
                           device=dev)
    sync(dev)
    t, w = model.tables.weight, model.wide.weight
    print(f"  {cfg.name}: {len(cfg.table_sizes)} fields, embed_dim "
          f"{cfg.embed_dim}, mlp {cfg.mlp}; fused tables {tuple(t.shape)} "
          f"{t.nbytes} bytes, wide {tuple(w.shape)} {w.nbytes} bytes; "
          f"{time.perf_counter() - t0:.2f} s")
    if t.is_cuda:
        print(f"  device memory: {torch.cuda.memory_allocated() / 1e9:.2f} "
              f"GB allocated")
    return cfg, model


def recsys_serve(cfg, model, dev):
    """make_serve_step over RecsysStream batches (drawn on the host and
    uploaded before the clock starts). Returns the first batch of 512 and
    its probabilities on the card, and the last batch of 262,144."""
    from repro_torch.data import RecsysStream
    from repro_torch.models import recsys as rs

    stream = RecsysStream(cfg, seed=SEED + 1)
    serve = rs.make_serve_step(cfg)
    first = None
    for B, n in RECSYS_SERVE_BATCHES.items():
        t0 = time.perf_counter()
        batches = [rs.as_batch(_no_label(stream.batch(B)), dev)
                   for _ in range(n)]
        sync(dev)
        draw_s = time.perf_counter() - t0
        ms = []
        with torch.inference_mode():
            for b in batches:
                t0 = time.perf_counter()
                p = serve(model, b)
                sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                if p.shape != (B,) or not bool(((p >= 0) & (p <= 1)).all()):
                    raise AssertionError("served probabilities malformed")
                if first is None:
                    first = (b, p)
        del p
        p50, p99, steady = _ms_stats(ms)
        print(f"  serve batch {B}: {n} batches (drawn in {draw_s:.2f} s); "
              f"batch_ms p50 {p50:.3f} p99 {p99:.3f} (first {ms[0]:.3f}); "
              f"{B * len(steady) / steady.sum() * 1e3:.1f} rows/s")
    return first, batches[-1]


def candidate_index(cfg, model, dev):
    """The CluSD candidate index of RECSYS_CANDIDATES items: uniform ids
    of the first two fields (as examples/recsys_clusd_retrieval.py draws
    them), their candidate_tower vectors, k-means, the cluster-blocked
    layout and the neighbour graph; an untrained selector."""
    from repro_torch.core import kmeans as km
    from repro_torch.core.lstm import LSTMSelector
    from repro_torch.core.retrieval import CandidateIndexSpec

    N, cap = RECSYS_CLUSTERS, RECSYS_CAP
    spec = CandidateIndexSpec(n_candidates=RECSYS_CANDIDATES, n_clusters=N,
                              cap=cap)
    rng = np.random.default_rng(SEED + 2)
    raw = torch.from_numpy(np.stack(
        [rng.integers(0, cfg.table_sizes[i], RECSYS_CANDIDATES)
         for i in range(2)], 1).astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        vecs = model.candidate_tower(raw)
    sync(dev)
    print(f"  candidate_tower over {RECSYS_CANDIDATES} items: "
          f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    cents, assign = km.kmeans(vecs, N, 10,
                              generator=torch.Generator().manual_seed(SEED),
                              device=dev)
    sync(dev)
    t1 = time.perf_counter()
    table, _ = km.build_cluster_table(assign.cpu().numpy(), N, cap,
                                      vecs.cpu().numpy(), cents.cpu().numpy())
    t2 = time.perf_counter()
    table = torch.from_numpy(table).to(dev)
    valid = table >= 0
    blocks = torch.zeros((N, cap, vecs.shape[1]), device=dev)
    blocks[valid] = vecs[table[valid].long()]
    cand = torch.zeros((N * cap, 2), dtype=torch.int32, device=dev)
    cand[valid.reshape(-1)] = raw[table[valid].long()]
    nb_ids, nb_sims = km.neighbor_graph(cents, 64)
    sel = LSTMSelector(1 + spec.u_bins + 2 * spec.v_bins, 32,
                       generator=torch.Generator().manual_seed(SEED)).to(dev)
    sync(dev)
    fill = valid.sum(1)
    print(f"  k-means (10 iterations) {t1 - t0:.2f} s; cluster table "
          f"(host greedy) {t2 - t1:.2f} s; fill min {fill.min().item()} max "
          f"{fill.max().item()} of {cap}; blocks {tuple(blocks.shape)}; "
          f"neighbour graph m 64")
    return {"spec": spec, "raw": raw, "cand": cand, "blocks": blocks,
            "cents": cents, "nb_ids": nb_ids, "nb_sims": nb_sims, "sel": sel,
            "valid": valid.reshape(-1).contiguous()}


def recsys_retrieve(cfg, model, ci, users, dev):
    """clusd_candidate_retrieval for each user row, one query at a time,
    beside brute_force_retrieval. Returns the CluSD (ids, scores)."""
    from repro_torch.core.retrieval import (brute_force_retrieval,
                                            clusd_candidate_retrieval)
    from repro_torch.models import recsys as rs

    n_slots = RECSYS_CLUSTERS * RECSYS_CAP
    batches = [rs.as_batch({k: v[q:q + 1] for k, v in users.items()}, dev)
               for q in range(RECSYS_QUERIES)]
    out, ms, bf_ms, overlap, n_sel = [], [], [], [], []
    with torch.inference_mode():
        for b in batches:
            t0 = time.perf_counter()
            ids, scores, diag = clusd_candidate_retrieval(
                cfg, ci["spec"], model, b, ci["cand"], ci["blocks"],
                ci["cents"], ci["sel"], ci["nb_ids"], ci["nb_sims"],
                slot_valid=ci["valid"])
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            bf_ids, _ = brute_force_retrieval(cfg, model, b, ci["blocks"],
                                              k=ci["spec"].k_final)
            sync(dev)
            bf_ms.append((time.perf_counter() - t0) * 1e3)
            ids_np, sc_np = ids.cpu().numpy(), scores.cpu().numpy()
            if ids_np.shape != (ci["spec"].k_final,) \
                    or not np.isfinite(sc_np).all() \
                    or (np.diff(sc_np) > 0).any() or ids_np.min() < 0 \
                    or ids_np.max() >= n_slots:
                raise AssertionError("retrieved candidates malformed")
            out.append((ids_np, sc_np))
            n_sel.append(int(diag["n_selected"]))
            overlap.append(len(set(ids_np.tolist())
                               & set(bf_ids.cpu().numpy().tolist()))
                           / ci["spec"].k_final)
    with torch.inference_mode():
        profile_call(lambda: clusd_candidate_retrieval(
            cfg, ci["spec"], model, batches[-1], ci["cand"], ci["blocks"],
            ci["cents"], ci["sel"], ci["nb_ids"], ci["nb_sims"],
            slot_valid=ci["valid"]), dev, 8, 4)
    p50, p99, steady = _ms_stats(ms)
    bp50, bp99, _ = _ms_stats(bf_ms)
    print(f"  CluSD retrieval, {len(ms)} queries one at a time: batch_ms "
          f"p50 {p50:.3f} p99 {p99:.3f} (first {ms[0]:.3f}); "
          f"{len(steady) / steady.sum() * 1e3:.1f} queries/s; n_selected "
          f"mean {np.mean(n_sel):.2f} ({np.mean(n_sel) * RECSYS_CAP:.0f} of "
          f"{n_slots} slots scored)")
    print(f"  brute force: batch_ms p50 {bp50:.3f} p99 {bp99:.3f}; top-"
          f"{ci['spec'].k_final} overlap with CluSD mean "
          f"{np.mean(overlap):.3f} (untrained selector and guide; for "
          f"information)")
    return out


def recsys_parity(cfg, model, ci, served, users, retrieved):
    """The card against the CPU (plain versions): logits on the first
    RECSYS_PARITY_ROWS rows of the first 512 batch, retrieval ids at
    isolated ranks on RECSYS_PARITY_QUERIES queries. Hard gates."""
    import copy

    from repro_torch.core.retrieval import clusd_candidate_retrieval
    from repro_torch.models import recsys as rs

    t0 = time.perf_counter()
    cpu = rs.RecsysModel(cfg, model.params, device="cpu")
    batch, probs = served
    n = RECSYS_PARITY_ROWS
    with torch.inference_mode():
        g_logit = rs.forward(cfg, model, {k: v[:n] for k, v in
                                          batch.items()}).cpu()
        c_logit = cpu({k: v[:n].cpu() for k, v in batch.items()})
    close = torch.allclose(g_logit, c_logit, rtol=1e-5, atol=1e-5)
    p_diff = (torch.sigmoid(c_logit) - probs[:n].cpu()).abs().max().item()
    print(f"  logits on {n} rows, card vs CPU: allclose(rtol 1e-5, atol "
          f"1e-5) {close}; max |diff| "
          f"{(g_logit - c_logit).abs().max().item():.3g}; served "
          f"probabilities vs CPU max |diff| {p_diff:.3g}")
    if not close:
        raise AssertionError("recsys logits: card and CPU disagree")
    moved = {k: v.cpu() if torch.is_tensor(v) else v for k, v in ci.items()}
    moved["sel"] = copy.deepcopy(ci["sel"]).cpu()
    bad = compared = 0
    close, max_diff = True, 0.0
    with torch.inference_mode():
        for q in range(RECSYS_PARITY_QUERIES):
            b = rs.as_batch({k: v[q:q + 1] for k, v in users.items()}, "cpu")
            c_ids, c_sc, _ = clusd_candidate_retrieval(
                cfg, moved["spec"], cpu, b, moved["cand"], moved["blocks"],
                moved["cents"], moved["sel"], moved["nb_ids"],
                moved["nb_sims"], slot_valid=moved["valid"])
            g_ids, g_sc = retrieved[q]
            ok = isolated_ranks(c_sc.numpy()[None], PARITY_GAP)[0]
            compared += int(ok.sum())
            bad += int((g_ids[ok] != c_ids.numpy()[ok]).sum())
            max_diff = max(max_diff, float(np.abs(g_sc - c_sc.numpy()).max()))
            close &= np.allclose(g_sc, c_sc.numpy(), rtol=1e-5, atol=1e-6)
    print(f"  retrieval on {RECSYS_PARITY_QUERIES} queries, card vs CPU: "
          f"ranks compared {compared}; id mismatches {bad}; scores "
          f"allclose(rtol 1e-5, atol 1e-6) {close}; max |score diff| "
          f"{max_diff:.3g}; {time.perf_counter() - t0:.2f} s")
    if bad or not close:
        raise AssertionError("recsys retrieval: card and CPU disagree")


def recsys_phase(dev):
    """Phase 9. Returns (launches of the recsys path, the kernel check's
    recsys inputs: the embedding_bag bags, the first query's guide row
    for topk, its bin_overlap inputs, and its Stage-I features with the
    selector for lstm_sequence)."""
    from repro_torch import kernels
    from repro_torch.core.retrieval import (clusd_candidate_retrieval,
                                            guide_scores)
    from repro_torch.data import RecsysStream
    from repro_torch.kernels.bin_overlap import ops as bo_ops
    from repro_torch.models import recsys as rs

    cfg, model = recsys_model(dev)
    users = _no_label(RecsysStream(cfg, seed=SEED + 3).batch(RECSYS_QUERIES))
    kernels.reset_launches()
    served, bulk = recsys_serve(cfg, model, dev)
    ci = candidate_index(cfg, model, dev)
    retrieved = recsys_retrieve(cfg, model, ci, users, dev)
    sync(dev)
    launches = dict(kernels.LAUNCHES)
    print(f"  recsys kernel launches: {launches}")
    recsys_parity(cfg, model, ci, served, users, retrieved)
    tables, wide = model.tables, model.wide
    n_user = len(cfg.table_sizes) // 2
    user_idx = (torch.from_numpy(users["sparse"][:1, :n_user]).to(dev)
                + tables.offsets[:n_user]).contiguous()
    serve_idx = (bulk["sparse"] + wide.offsets).contiguous()
    bags = {"guide": (wide.weight,
                      (ci["cand"] + wide.offsets[:2]).contiguous()),
            "user_tower": (tables.weight, user_idx),
            "serve_wide": (wide.weight, serve_idx),
            "candidate_tower": (tables.weight,
                                (ci["raw"] + tables.offsets[:2]).contiguous())}
    # the guide row the first query ranks, as clusd_candidate_retrieval
    # makes it: the wide bag over every slot, pad slots at -inf
    with torch.inference_mode():
        b = rs.as_batch({k: v[:1] for k, v in users.items()}, dev)
        blocks = ci["blocks"]
        g = guide_scores(cfg, model, rs.user_tower(cfg, model, b),
                         blocks.reshape(-1, blocks.shape[2]), ci["cand"])
        guide_row = torch.where(ci["valid"], g, -torch.inf)[None]
        # the (1, n, F) Stage-I features the selector's lstm_sequence gets
        # and the (1, k_guide) results bin_overlap gets
        got, overlap = [], []
        hook = ci["sel"].register_forward_pre_hook(
            lambda mod, args: got.append(args[0]))
        real = bo_ops.bin_overlap
        bo_ops.bin_overlap = lambda *a, **kw: (overlap.append((a, kw)),
                                               real(*a, **kw))[1]
        try:
            clusd_candidate_retrieval(cfg, ci["spec"], model, b, ci["cand"],
                                      blocks, ci["cents"], ci["sel"],
                                      ci["nb_ids"], ci["nb_sims"],
                                      slot_valid=ci["valid"])
        finally:
            bo_ops.bin_overlap = real
            hook.remove()
    feats = got[0].float().contiguous().clone()   # a normal tensor again
    (c_of, bins, gn), kw = overlap[0]
    return launches, {"bags": bags, "guide_row": guide_row,
                      "k_guide": ci["spec"].k_guide,
                      "overlap": (c_of.clone(), bins.clone(), gn.clone(),
                                  kw["n_clusters"], kw["v"]),
                      "lstm": (feats, ci["sel"])}


def main_path_inputs(eng, qs, dev):
    """The kernels' inputs for the last batch of MAX_BATCH served queries,
    made by the engine's own stage functions as RetrievalEngine runs
    them: queries, the LUT (ADC), Stage-I features, the batch's unique
    blocks (code blocks or float blocks) and each slot's position."""
    from repro_torch.engine import pipeline as pipe_lib

    q3 = queries(qs, N_QUERIES - MAX_BATCH, N_QUERIES)
    qd = torch.tensor(q3[0], dtype=torch.float32).to(dev)
    qt = torch.tensor(q3[1], dtype=torch.int32).to(dev)
    qw = torch.tensor(q3[2], dtype=torch.float32).to(dev)
    cfg, index, store = eng.cfg, eng.index, eng.store
    with torch.no_grad():
        _, _, cand, feats = pipe_lib.build_stage1_fn(cfg, index)(qd, qt, qw)
        sel_ids, sel_mask, _ = pipe_lib.build_stage2_fn(cfg, index)(cand,
                                                                    feats)
        lut = pipe_lib.build_lut_fn(store.codebooks, store.rotation,
                                    dev)(qd) if eng.use_adc else None
    uniq, pos = pipe_lib.dedup_selected(sel_ids.cpu().numpy(),
                                        sel_mask.cpu().numpy())
    fetch = pipe_lib.fetch_unique_code_blocks if eng.use_adc \
        else pipe_lib.fetch_unique_blocks
    blocks = fetch(store, uniq)
    return {"q": qd, "lut": lut, "feats": feats.float().contiguous(),
            "blocks": torch.from_numpy(blocks).to(dev),
            "pos": torch.from_numpy(pos).to(dev)}


def check_kernels(dev, launches, v2, v1, tail, codebooks, selector, eb,
                  nb_sims, cs_notes):
    """Each kernel vs its plain version on the main path's inputs."""
    from repro_torch.kernels.adc import (adc_score_blocks,
                                         adc_score_blocks_ref, adc_tables,
                                         adc_tables_ref)
    from repro_torch.kernels.bin_overlap import bin_overlap, bin_overlap_ref
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_ref)
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    from repro_torch.kernels.lstm import lstm_sequence, lstm_sequence_ref
    from repro_torch.kernels.topk import topk, topk_ref

    rows = []

    # adc_tables: (B, dim) queries, (nsub, K, dsub) codebooks
    q, books = v2["q"], codebooks
    B, dim = q.shape
    nsub, K, dsub = books.shape
    lut = adc_tables(q, books)
    ref = adc_tables_ref(q, books)
    torch.cuda.synchronize()
    err = (lut - ref).abs().max().item()
    if not torch.equal(lut.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError(f"adc_tables is not bitwise the plain version: "
                             f"{err}")
    qs = q.reshape(B, nsub, dsub)
    lib = torch.einsum("bsd,skd->bsk", qs, books)
    lib_err = (lib - ref).abs().max().item()
    b_ms, b_by = bound(4 * (B * dim + books.numel() + B * nsub * K),
                       2 * B * nsub * K * dsub)
    rows.append({"name": "adc_tables", "route": "cuda",
                 "source": "src/repro_torch/csrc/adc.cu",
                 "replaces": "src/repro/kernels/adc/kernel.py:38",
                 "launches": launches["adc_tables"], "max_abs_err": err,
                 "ms": graph_ms(lambda: adc_tables(q, books), 50),
                 "plain_ms": cuda_ms(lambda: adc_tables_ref(q, books), 10),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": graph_ms(lambda: torch.einsum(
                     "bsd,skd->bsk", qs, books), 50),
                 "shapes": [(B, dim), (nsub, K, dsub), "eager op ms "
                            f"{cuda_ms(lambda: adc_tables(q, books), 50):.4f}"],
                 "library_max_abs_err": lib_err})

    # adc_score_blocks, each input bitwise the plain version: the v2
    # batch's LUT, unique code blocks and positions, and the PQStore
    # batch's LUT, whole (N, cap, nsub) code table and cluster ids. The
    # row's times are v2's. Bytes: the LUTs, the code blocks that `sel`
    # reaches, `sel`, the scores. The gather floor: B*S*cap*nsub LUT
    # lookups at 32 per SM per clock (no bank conflicts) at the card's
    # maximum SM clock.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0]) * 1e6
    notes, t = [], None
    for key, (lut, codes, sel) in (
            ("v2", (v2["lut"], v2["blocks"], v2["pos"])),
            ("pq", tail["pq_adc"])):
        U, cap, nsub = codes.shape
        (B, S), K = sel.shape, lut.shape[2]
        out = adc_score_blocks(lut, codes, sel)
        ref = adc_score_blocks_ref(lut, codes, sel)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"adc_score_blocks on the {key} input is "
                                 "not bitwise the plain version: "
                                 f"{(out - ref).abs().max().item()}")
        n_read = torch.unique(sel).numel()
        b_ms, b_by = bound(4 * B * nsub * K + n_read * cap * nsub + 4 * B * S
                           + 4 * B * S * cap, B * S * cap * nsub)
        tt = {"ms": graph_ms(lambda: adc_score_blocks(lut, codes, sel)),
              "plain_ms": cuda_ms(
                  lambda: adc_score_blocks_ref(lut, codes, sel), 3),
              "bound_ms": b_ms, "bound_by": b_by,
              "gather_floor_ms": B * S * cap * nsub / (32 * sms * clock_hz)
              * 1e3}
        notes.append((key, (U, cap, nsub), (B, S), n_read, tt))
        if t is None:
            t, err = tt, (out - ref).abs().max().item()
        del out, ref
    rows.append({"name": "adc_score_blocks", "route": "cuda",
                 "source": "src/repro_torch/csrc/adc.cu",
                 "replaces": "src/repro/kernels/adc/kernel.py:79",
                 "launches": launches["adc_score_blocks"], "max_abs_err": err,
                 **{k: v for k, v in t.items() if k != "gather_floor_ms"},
                 "library_ms": None,
                 "shapes": [f"{key} codes {shape} sel {bs} {n} blocks read: "
                            f"ms {tt['ms']:.4f} plain {tt['plain_ms']:.4f} "
                            f"bound {tt['bound_ms']:.4f} ({tt['bound_by']}) "
                            f"gather floor {tt['gather_floor_ms']:.4f} at "
                            f"{clock_hz / 1e6:.0f} MHz"
                            for key, shape, bs, n, tt in notes]})

    # cluster_score: the v1 batch's queries, unique float blocks and
    # positions (the row's numbers), the memory store's shape (`cs_notes`,
    # taken while its table was on the card) and the grouping check
    q, blocks, sel = v1["q"], v1["blocks"], v1["pos"]
    t = cluster_score_case("v1 tail", q, blocks, sel,
                           gathered_einsum(q, blocks, sel))
    rows.append({"name": "cluster_score", "route": "cuda",
                 "source": "src/repro_torch/csrc/cluster_score.cu",
                 "replaces": "src/repro/kernels/cluster_score/kernel.py:30",
                 "launches": launches["cluster_score"],
                 **{k: v for k, v in t.items() if k != "note"},
                 "shapes": [t["note"], *cs_notes, cluster_score_groups(dev)]})

    # lstm_sequence, each input within atol 1e-5 of the plain version,
    # with nn.LSTM (cuDNN, TF32 off) on the same weights by the same
    # method: the v2 batch's (256, n, F) Stage-I features through its
    # selector, and the recsys query's (1, n, F) through the candidate
    # index's. The row's times are v2's.
    notes, t = [], None
    for key, (x, mod) in (("v2", (v2["feats"], selector)),
                          ("recsys", eb["lstm"])):
        w = {k: p.detach() for k, p in mod.named_parameters()}
        (B, n, F), (H, G) = x.shape, w["wh"].shape
        out = lstm_sequence(x, w["wx"], w["wh"], w["b"])
        ref = lstm_sequence_ref(x, w["wx"], w["wh"], w["b"])
        torch.cuda.synchronize()
        e = (out - ref).abs().max().item()
        if not e <= 1e-5:
            raise AssertionError(f"lstm_sequence on the {key} input "
                                 f"disagrees with plain: {e}")
        lstm = torch.nn.LSTM(F, H, batch_first=True).to(dev)
        with torch.no_grad():
            lstm.weight_ih_l0.copy_(w["wx"].T)
            lstm.weight_hh_l0.copy_(w["wh"].T)
            lstm.bias_ih_l0.copy_(w["b"])
            lstm.bias_hh_l0.zero_()
            lib_err = (lstm(x)[0] - ref).abs().max().item()
            lib_ms = graph_ms(lambda: lstm(x), 50)
        b_ms, b_by = bound(4 * (x.numel() + F * G + H * G + G + B * n * H),
                           2 * B * n * G * (F + H))
        tt = {"ms": graph_ms(lambda: lstm_sequence(
                  x, w["wx"], w["wh"], w["b"]), 50),
              "plain_ms": cuda_ms(lambda: lstm_sequence_ref(
                  x, w["wx"], w["wh"], w["b"]), 10),
              "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        notes.append((key, (B, n, F, H), e, lib_err, tt))
        if t is None:
            t, err, first_lib_err = tt, e, lib_err
    rows.append({"name": "lstm_sequence", "route": "cuda",
                 "source": "src/repro_torch/csrc/lstm.cu",
                 "replaces": "src/repro/kernels/lstm/kernel.py:46",
                 "launches": launches["lstm_sequence"], "max_abs_err": err,
                 **t,
                 "shapes": [f"{key} (B, n, F, H) {shape}: ms {tt['ms']:.4f} "
                            f"plain {tt['plain_ms']:.4f} nn.LSTM "
                            f"{tt['library_ms']:.4f} bound "
                            f"{tt['bound_ms']:.4f}; max_abs_err {e:.3g}, "
                            f"nn.LSTM's {le:.3g}"
                            for key, shape, e, le, tt in notes],
                 "library_max_abs_err": first_lib_err})
    # topk on the main path's rows, each bitwise the plain version: the
    # fuse top-k over the last batch's fused buffer and the sparse top-k
    # over its score matrix (row-strided views), Stage I's query-centroid
    # similarities (sort_by_dist), the recsys guide row (-inf pads) and
    # the update path's neighbor graph (the v2 directory's (N, N) centroid
    # similarities, self pushed down, k 128). The row's times are the
    # fused rows'.
    errs, notes = [], []
    for key, x, kk in (("fused", tail["fused"], tail["k_final"]),
                       ("sparse", tail["sparse"], tail["k_sparse"]),
                       ("stage1", tail["qc_sim"], tail["n_stage1"]),
                       ("guide", eb["guide_row"], eb["k_guide"]),
                       ("neighbor", nb_sims, tail["n_neighbors"])):
        v, i = topk(x, kk)
        rv, ri = topk_ref(x, kk)
        torch.cuda.synchronize()
        if not (torch.equal(i, ri)
                and torch.equal(v.view(torch.int32), rv.view(torch.int32))):
            raise AssertionError(f"topk on the {key} rows is not bitwise "
                                 f"the plain version")
        errs.append((v - rv).abs().nan_to_num().max().item())
        del v, i, rv, ri
        B, D = x.shape
        b_ms, b_by = bound(4 * B * D + 12 * B * kk, B * D)
        t = {"ms": graph_ms(lambda: topk(x, kk)),
             "plain_ms": cuda_ms(lambda: topk_ref(x, kk), 3),
             "library_ms": graph_ms(lambda: torch.topk(x, kk), 5),
             "bound_ms": b_ms, "bound_by": b_by,
             "eager_ms": cuda_ms(lambda: topk(x, kk), 10)}
        notes.append((key, (B, D), x.stride(0), kk, t))
    _, (B, D), stride, kk, t = notes[0]
    rows.append({"name": "topk", "route": "cuda",
                 "source": "src/repro_torch/csrc/topk.cu",
                 "replaces": "src/repro/kernels/topk/kernel.py:36",
                 "launches": launches["topk"], "max_abs_err": max(errs),
                 **{k: v for k, v in t.items() if k != "eager_ms"},
                 "shapes": [f"{key} ({shape[0]}, {shape[1]}) row stride "
                            f"{st} k {kk_}: " + ", ".join(
                                f"{a} {b:.4f}" if isinstance(b, float)
                                else f"{a} {b}" for a, b in tt.items())
                            for key, shape, st, kk_, tt in notes]})

    # bin_overlap, each input bitwise the plain version on the CPU (on the
    # card the plain version adds with atomics): Stage I's P/Q over the
    # last batch's sparse top-k, and the recsys query's over its guide
    # top-k. The row's times are Stage I's; `wrapper_ms` is the eager op.
    notes, t = [], None
    for key, (c_of, bins, norm, N, nv) in (
            ("stage1", (tail["c_of"], tail["bin_ids"], tail["norm"],
                        tail["n_clusters"], tail["v"])),
            ("recsys", eb["overlap"])):
        P, Q = bin_overlap(c_of, bins, norm, n_clusters=N, v=nv)
        cP, cQ = bin_overlap_ref(c_of.cpu(), bins.cpu(), norm.cpu(),
                                 n_clusters=N, v=nv)
        gP, gQ = bin_overlap_ref(c_of, bins, norm, n_clusters=N, v=nv)
        torch.cuda.synchronize()
        if not (torch.equal(P.cpu(), cP) and torch.equal(
                Q.cpu().view(torch.int32), cQ.view(torch.int32))):
            raise AssertionError(f"bin_overlap on the {key} input is not "
                                 "bitwise the plain version")
        B, k = c_of.shape
        b_ms, b_by = bound(8 * B * N * nv + 8 * B * k + 4 * bins.numel(),
                           B * k)
        reps = 20 if B > 1 else 100
        tt = {"ms": graph_ms(lambda: bin_overlap(
                  c_of, bins, norm, n_clusters=N, v=nv), reps),
              "wrapper_ms": cuda_ms(lambda: bin_overlap(
                  c_of, bins, norm, n_clusters=N, v=nv), reps),
              "plain_ms": cuda_ms(lambda: bin_overlap_ref(
                  c_of, bins, norm, n_clusters=N, v=nv), 10),
              "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        notes.append((key, (B, k), tuple(bins.shape), N, nv,
                      int((P > 1).sum()),
                      (gQ.cpu() - cQ).abs().max().item(), tt))
        if t is None:
            t, err = tt, (Q.cpu() - cQ).abs().max().item()
        del P, Q, gP, gQ
    rows.append({"name": "bin_overlap", "route": "cuda",
                 "source": "src/repro_torch/csrc/bin_overlap.cu",
                 "replaces": "src/repro/kernels/bin_overlap/kernel.py:39",
                 "launches": launches["bin_overlap"], "max_abs_err": err,
                 **{k: v for k, v in t.items() if k != "wrapper_ms"},
                 "shapes": [f"{key} c_of {bk} bins {bs} N {N_} v {v_}: ms "
                            f"{tt['ms']:.4f} wrapper {tt['wrapper_ms']:.4f} "
                            f"plain {tt['plain_ms']:.4f} bound "
                            f"{tt['bound_ms']:.4f}; P > 1 in {p1} slots; "
                            f"plain on the card (atomics) vs CPU: Q {e:.3g}"
                            for key, bk, bs, N_, v_, p1, e, tt in notes]})
    # embedding_bag: the recsys path's four bags, each bitwise the plain
    # version; the row's times are the guide's, the per-query bag over
    # every candidate slot. Bytes: the DISTINCT table rows read (the
    # heavy-tailed ids hit in L2), the indices and the output; the
    # sector floor counts the table reads as the distinct 32-byte sectors
    # those rows span. `ms` is the launch alone; `wrapper_ms` the public
    # op, with its stream sync and error-word read.
    notes, t = [], None
    for key in ("guide", "user_tower", "serve_wide", "candidate_tower"):
        table, idx = eb["bags"][key]
        out = embedding_bag(table, idx)
        ref = embedding_bag_ref(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"embedding_bag on the {key} input is not "
                                 "bitwise the plain version")
        B, hot = idx.shape
        d = table.shape[1]
        rows_read = torch.unique(idx).numel()
        io = 4 * idx.numel() + 4 * B * d
        b_ms, b_by = bound(4 * rows_read * d + io, B * hot * d)
        lib = torch.nn.functional.embedding_bag(idx, table, mode="sum")
        out = torch.empty_like(ref)
        word = torch.zeros(1, dtype=torch.int64, device=dev)
        tt = {"ms": graph_ms(
                  lambda: eb_kernel.embedding_bag_cuda(table, idx, out, word)),
              "wrapper_ms": cuda_ms(lambda: embedding_bag(table, idx), 20),
              "plain_ms": cuda_ms(lambda: embedding_bag_ref(table, idx), 5),
              "library_ms": graph_ms(
                  lambda: torch.nn.functional.embedding_bag(
                      idx, table, mode="sum")),
              "bound_ms": b_ms, "bound_by": b_by,
              "sector_floor_ms": (32 * table_sectors(table, idx) + io)
              / HBM_BYTES_PER_S * 1e3,
              "library_max_abs_err": (lib - ref).abs().max().item()}
        notes.append((key, (B, hot, d), rows_read, tt))
        if t is None:
            t, err = tt, (out - ref).abs().max().item()
    rows.append({"name": "embedding_bag", "route": "cuda",
                 "source": "src/repro_torch/csrc/embedding_bag.cu",
                 "replaces": "src/repro/kernels/embedding_bag/kernel.py:28",
                 "launches": launches["embedding_bag"], "max_abs_err": err,
                 **{k: v for k, v in t.items()
                    if k not in ("wrapper_ms", "sector_floor_ms")},
                 "shapes": [f"{key} (B, hot, d) {shape} {n} rows: ms "
                            f"{tt['ms']:.4f} wrapper {tt['wrapper_ms']:.4f} "
                            f"plain {tt['plain_ms']:.4f} library "
                            f"{tt['library_ms']:.4f} bound "
                            f"{tt['bound_ms']:.4f} sector floor "
                            f"{tt['sector_floor_ms']:.4f}"
                            for key, shape, n, tt in notes]})
    for r in rows:
        print(f"  {r['name']}: kernel_ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} library_ms {r['library_ms']} bound_ms "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) launches "
              f"{r['launches']} max_abs_err {r['max_abs_err']:.3g} "
              f"library_max_abs_err {r.get('library_max_abs_err')} shapes "
              f"{r['shapes']}", flush=True)
    return rows


def offline_phase(cfg, emb_path, doc_terms, doc_weights, selector, qs, tmp,
                  dev):
    """build_index_offline over an np.memmap of the corpus, its peak
    device memory gated by the bound below, then a v2 write from the
    memmap whose PQ the writer trains (train_pq_stream) and one served
    batch. Returns the launch counts of the run."""
    from repro_torch import kernels
    from repro_torch.index import IndexReader, build_index_offline, write_index
    from repro_torch.obs import Tracer

    on_card = torch.device(dev).type == "cuda"
    D, dim, N = cfg.n_docs, cfg.dim, cfg.n_clusters
    mm = np.memmap(emb_path, np.float32, "r", shape=(D, dim))
    init = np.sort(torch.randperm(D, generator=torch.Generator().manual_seed(
        SEED))[:N].numpy())
    tracer = Tracer(sample_rate=1.0)
    kernels.reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    index = build_index_offline(cfg, mm, doc_terms, doc_weights,
                                shard_docs=OFFLINE_SHARD_DOCS, init_idx=init,
                                device=dev, tracer=tracer)
    sync(dev)
    build_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) if on_card else 0
    # What the build holds on the card at once. During k-means: one shard
    # (2^17 x 768 x 4 = 403 MB), the old and new centroids, and _assign's
    # chunk of 2^27 // N rows, whose (rows, N) float32 distance expression
    # keeps three buffers live at once (x2 + c2, 2 X C^T, their
    # difference: 3 x 537 MB at N 8192); _cluster_sums' (rows, N) float64
    # one-hot and its products (1.28 GB) come below that. Then the index
    # it returns (postings, cluster table, neighbor graph) beside
    # neighbor_graph's three live (N, N) float32 buffers. 64 MB more for
    # cuBLAS's workspace and the small per-chunk tensors.
    sp = index.sparse_index
    out_bytes = sum(t.numel() * t.element_size() for t in (
        sp.postings_docs, sp.postings_weights, index.cluster_docs,
        index.doc_cluster, index.neighbor_ids, index.neighbor_sims,
        index.centroids, index.bin_ids))
    rows = max(1, (1 << 27) // N)
    bound = max(OFFLINE_SHARD_DOCS * dim * 4 + 2 * N * dim * 4
                + 3 * rows * N * 4, out_bytes + 3 * N * N * 4) + (64 << 20)
    cd = index.cluster_docs.cpu().numpy()
    members = np.sort(cd[cd >= 0])
    totals = tracer.span_totals("build_index")
    print(f"  build_index_offline over the {D} x {dim} memmap "
          f"({os.path.getsize(emb_path)} bytes), shards of "
          f"{OFFLINE_SHARD_DOCS}: {build_s:.2f} s; spans (ms) "
          f"{json.dumps({k: v['ms'] for k, v in totals.items()})}")
    print(f"  peak device memory {peak / 1e9:.3f} GB against the bound "
          f"{bound / 1e9:.3f} GB (index {out_bytes / 1e9:.3f} GB); the "
          f"in-RAM build_index's peak {BUILD_INDEX_PEAK / 1e9:.3f} GB")
    if on_card and not 0 < peak <= bound:
        raise AssertionError("the memmap build's device memory exceeds its "
                             "bound")
    if not np.array_equal(members, np.arange(D)) or cd.shape != (
            N, cfg.cluster_cap):
        raise AssertionError("the offline cluster table does not hold every "
                             "doc exactly once within cap")
    fill = (cd >= 0).sum(1)
    print(f"  cluster table: every doc once, fill min {fill.min()} max "
          f"{fill.max()} <= cap {cfg.cluster_cap}")
    index.selector = selector
    out = os.path.join(tmp, "offline_v2")
    t0 = time.perf_counter()
    man = write_index(out, cfg, index, mm, n_shards=N_SHARDS,
                      format_version=2, pq_nsub=NSUB,
                      chunk_docs=PQ_CHUNK_DOCS, extra=corpus_extra(cfg),
                      tracer=tracer)
    totals = tracer.span_totals("write_index")
    print(f"  write_index v2 from the memmap, PQ nsub {NSUB} trained by "
          f"train_pq_stream in {PQ_CHUNK_DOCS}-row reads: "
          f"{time.perf_counter() - t0:.2f} s, {man['total_bytes']} bytes; "
          f"spans (ms) {json.dumps({k: v['ms'] for k, v in totals.items()})}")
    del index, mm
    with IndexReader.open(out, verify="full").engine(
            max_batch=MAX_BATCH, device=dev) as eng:
        ids, scores = eng.retrieve(*queries(qs, 0, MAX_BATCH))
        sync(dev)
        st = eng.stats()
    check_results(cfg, ids, scores, MAX_BATCH)
    launches = dict(kernels.LAUNCHES)
    print(f"  served one batch of {MAX_BATCH}: failed batches 0, prefetch "
          f"errors {st['prefetch_errors']}; launches {launches}")
    if st["prefetch_errors"]:
        raise AssertionError("serving the offline build failed")
    os.remove(emb_path)
    shutil.rmtree(out)
    return launches


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def compare_generations(card_dir, cpu_dir, delta):
    """The same delta committed on the card and on the CPU: manifests
    equal but for wall times and the sha256 of the files below; every
    file of the new generation byte-equal, but for upsert code rows whose
    pq_encode argmin is a near-tie (relative gap of the two codes'
    squared distances under 1e-5) and, after a re-cluster, the neighbor
    graph (ids at isolated ranks, sims rtol 1e-5, atol 1e-6). Returns
    the number of near-tie codes."""
    mans = [_manifest(card_dir), _manifest(cpu_dir)]
    g = mans[1]["generation"]
    loose = {s["file"] for s in mans[1]["block_shards"]
             if s["file"].endswith(f".g{g}.codes.bin")}
    if mans[1]["update_stats"]["reclustered_shards"]:
        ids, sims = (mans[1]["arrays"][k]
                     for k in ("neighbor_ids", "neighbor_sims"))
        loose |= {ids, sims}
        check_neighbors(*(np.load(os.path.join(card_dir, r))
                          for r in (ids, sims)),
                        *(np.load(os.path.join(cpu_dir, r))
                          for r in (ids, sims)))
    for m in mans:
        m["update_stats"].pop("wall_s")
        for rel in loose:
            m["files"][rel].pop("sha256")
    if mans[0] != mans[1]:
        raise AssertionError("card and CPU manifests of one delta differ")
    for rel in mans[1]["files"]:
        if f".g{g}" in rel and rel not in loose:
            with open(os.path.join(card_dir, rel), "rb") as f, \
                    open(os.path.join(cpu_dir, rel), "rb") as h:
                if f.read() != h.read():
                    raise AssertionError(f"{rel} differs card vs CPU")
    books = np.load(os.path.join(cpu_dir, mans[1]["pq"]["arrays"][
        "codebooks"])).astype(np.float64) if mans[1]["pq"] else None
    cd = np.load(os.path.join(cpu_dir, mans[1]["arrays"]["cluster_docs"]))
    row_of = {int(d): i for i, d in enumerate(delta.upsert_ids)}
    n_ties = 0
    for s in mans[1]["block_shards"]:
        if s["file"] not in loose:
            continue
        nsub = books.shape[0]
        a, b = (np.fromfile(os.path.join(d, s["file"]), np.uint8).reshape(
            -1, cd.shape[1], nsub) for d in (card_dir, cpu_dir))
        for c, slot, sub in np.argwhere(a != b):
            d = int(cd[s["cluster_lo"] + c, slot])
            if d not in row_of:
                raise AssertionError(f"doc {d}'s code moved, not an upsert")
            xs = delta.upsert_embeddings[row_of[d]].astype(
                np.float64).reshape(nsub, -1)[sub]
            da = ((xs - books[sub, a[c, slot, sub]]) ** 2).sum()
            db = ((xs - books[sub, b[c, slot, sub]]) ** 2).sum()
            if abs(da - db) > 1e-5 * max(da, db):
                raise AssertionError(f"doc {d} subspace {sub}: codes differ "
                                     f"off a near-tie")
            n_ties += 1
    return n_ties


def check_neighbors(ids, sims, ref_ids, ref_sims):
    """A neighbor graph against a reference: ids equal at ranks more than
    PARITY_GAP from both neighbours' sims, sims rtol 1e-5, atol 1e-6."""
    ok = isolated_ranks(ref_sims, PARITY_GAP)
    bad = int((ids[ok] != ref_ids[ok]).sum())
    close = np.allclose(sims, ref_sims, rtol=1e-5, atol=1e-6)
    print(f"  neighbor graph: id mismatches {bad} over {int(ok.sum())} of "
          f"{ok.size} ranks; sims allclose {close}, max |diff| "
          f"{np.abs(sims - ref_sims).max():.3g}")
    if bad or not close:
        raise AssertionError("neighbor graphs disagree")


def update_v2_phase(v2_dir, tmp, dev):
    """The port's update CLI in process on the card (1 % churn, serving
    before and after a hot reload, a compacted copy's parity), then the
    same synth_delta committed on the CPU to a copy: the two generations
    compared by compare_generations. Returns the launch counts of the CLI
    run."""
    from repro_torch import kernels
    from repro_torch.index import IndexReader, write_index_delta
    from repro_torch.launch import update_index

    cpu_dir = os.path.join(tmp, "v2_cpu")
    shutil.copytree(v2_dir, cpu_dir)
    trace = os.path.join(tmp, "update.jsonl")
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = update_index.main([
        "--index-dir", v2_dir, "--upserts", str(UPDATE_UPSERTS),
        "--deletes", str(UPDATE_DELETES), "--seed", "0",
        "--serve-queries", str(N_QUERIES), "--batch", str(MAX_BATCH),
        "--check-parity", "--trace-out", trace, "--device", str(dev)])
    sync(dev)
    launches = dict(kernels.LAUNCHES)
    print(f"  update_index.main: rc {rc} in {time.perf_counter() - t0:.2f} "
          f"s; launches {launches}")
    if rc != 0:
        raise AssertionError("the update CLI failed")
    st = _manifest(v2_dir)["update_stats"]
    spans = {}
    with open(trace) as f:
        for ln in f:
            r = json.loads(ln)
            if r["trace_name"] in ("write_index_delta", "reload_index",
                                   "compact_index", "write_index"):
                key = f"{r['trace_name']}/{r['span']}"
                spans[key] = round(spans.get(key, 0.0) + r["dur_ms"], 3)
    print(f"  generation 1: shards rewritten {st['shards_rewritten']} of "
          f"{N_SHARDS}, reclustered {st['reclustered_shards']}, "
          f"bytes_rewritten {st['bytes_rewritten']} of "
          f"{st['shard_bytes_total']} "
          f"({st['bytes_rewritten'] / st['shard_bytes_total']:.4f}), "
          f"wall {st['wall_s']} s; span totals (ms) {json.dumps(spans)}")
    t0 = time.perf_counter()
    delta, _ = update_index.synth_delta(IndexReader.open(cpu_dir),
                                        UPDATE_UPSERTS, UPDATE_DELETES,
                                        seed=0)
    write_index_delta(cpu_dir, delta, verify="none", device="cpu")
    print(f"  the same delta on the CPU: {time.perf_counter() - t0:.2f} s")
    n_ties = compare_generations(v2_dir, cpu_dir, delta)
    print(f"  card vs CPU generation 1: every staged file equal; upsert "
          f"codes differing at near-ties {n_ties} of "
          f"{delta.n_upserts * NSUB}")
    shutil.rmtree(cpu_dir)
    return launches


def update_v1_phase(v1_dir, qs, dev):
    """A re-clustering delta committed on the card while a second thread
    serves the v1 directory, reload_index() to generation 1 (gated
    against a fresh engine, deleted ids and a CPU neighbor graph), then
    compact_index in place, a full verify and reload_index() to
    generation 2. Returns the launch counts of the run."""
    from repro_torch import kernels
    from repro_torch.core import kmeans as km
    from repro_torch.index import (IndexReader, compact_index,
                                   write_index_delta)
    from repro_torch.launch.update_index import synth_delta

    q_next = queries(qs, 0, MAX_BATCH)
    eng = IndexReader.open(v1_dir, verify="size").engine(
        max_batch=MAX_BATCH, device=dev)
    t0 = time.perf_counter()
    delta, info = synth_delta(IndexReader.open(v1_dir), UPDATE_UPSERTS,
                              UPDATE_DELETES, seed=1)
    print(f"  synth_delta: {delta.n_upserts} upserts, {delta.n_deletes} "
          f"deletes, {info['target_shards']} target shard(s) in "
          f"{time.perf_counter() - t0:.2f} s")
    kernels.reset_launches()
    failures, served = [], []
    started = threading.Event()

    def serve():
        for i in range(2):
            try:
                started.set()
                eng.retrieve(*queries(qs, i * MAX_BATCH,
                                      (i + 1) * MAX_BATCH))
                served.append(i)
            except Exception as e:      # counted and raised below
                failures.append(repr(e))

    th = threading.Thread(target=serve)
    th.start()
    if not started.wait(600):
        raise AssertionError("the serving thread did not start")
    topk0 = kernels.LAUNCHES["topk"]
    t0 = time.perf_counter()
    rep = write_index_delta(v1_dir, delta, recluster_overflow=0.0,
                            recluster_min_overflow=0, device=dev)
    commit_s = time.perf_counter() - t0
    graph_topk = kernels.LAUNCHES["topk"] - topk0
    th.join(900)
    if th.is_alive():
        raise AssertionError("the serving thread did not finish")
    print(f"  write_index_delta (re-cluster) beside {len(served)} batches: "
          f"{commit_s:.2f} s; generation {rep['generation']}, shards "
          f"rewritten {rep['shards_rewritten']}, reclustered "
          f"{rep['reclustered_shards']}, bytes_rewritten "
          f"{rep['bytes_rewritten']} ({rep['bytes_rewritten_frac']}), "
          f"topk launches during the commit {graph_topk} (some are the "
          f"serving thread's); failed batches {len(failures)} {failures}")
    on_card = torch.device(dev).type == "cuda"
    if failures or len(served) != 2 or rep["generation"] != 1 \
            or not rep["reclustered_shards"] or (on_card and graph_topk < 1):
        raise AssertionError("the re-clustering delta failed its checks")
    t0 = time.perf_counter()
    gen = eng.reload_index()
    ids1, sc1 = eng.retrieve(*q_next)
    sync(dev)
    print(f"  reload_index -> generation {gen} + one batch: "
          f"{time.perf_counter() - t0:.2f} s")
    ids1, sc1 = ids1.cpu().numpy(), sc1.cpu().numpy()
    gone = int(np.isin(ids1, delta.delete_ids).sum())
    with IndexReader.open(v1_dir).engine(max_batch=MAX_BATCH, prefetch=False,
                                         device=dev) as fresh:
        f_ids, f_sc = (t.cpu().numpy() for t in fresh.retrieve(*q_next))
    ok = isolated_ranks(f_sc, PARITY_GAP)
    bad = int((ids1[ok] != f_ids[ok]).sum())
    print(f"  generation 1 vs a fresh engine: id mismatches {bad} over "
          f"{int(ok.sum())} of {ok.size} ranks; deleted ids served {gone}")
    if gen != 1 or bad or gone or not np.allclose(sc1, f_sc, rtol=1e-5,
                                                  atol=1e-6):
        raise AssertionError("generation 1 serves wrongly")
    man = _manifest(v1_dir)
    C, nb_ids, nb_sims = (np.load(os.path.join(v1_dir, man["arrays"][k]))
                          for k in ("centroids", "neighbor_ids",
                                    "neighbor_sims"))
    ref_ids, ref_sims = km.neighbor_graph(torch.from_numpy(C),
                                          nb_ids.shape[1])
    check_neighbors(nb_ids, nb_sims, ref_ids.numpy(), ref_sims.numpy())
    t0 = time.perf_counter()
    cman = compact_index(v1_dir, device=dev)
    compact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    IndexReader.open(v1_dir, verify="full")
    verify_s = time.perf_counter() - t0
    gen2 = eng.reload_index()
    ids2, sc2 = (t.cpu().numpy() for t in eng.retrieve(*q_next))
    sync(dev)
    launches = dict(kernels.LAUNCHES)
    eng.close()
    ok = isolated_ranks(sc1, PARITY_GAP)
    bad = int((ids2[ok] != ids1[ok]).sum())
    print(f"  compact_index in place: {compact_s:.2f} s, generation "
          f"{cman['generation']}, {cman['total_bytes']} bytes; verify full "
          f"{verify_s:.2f} s; reload -> generation {gen2}: id mismatches "
          f"against generation 1 {bad} over {int(ok.sum())} ranks; "
          f"launches {launches}")
    if gen2 != 2 or bad:
        raise AssertionError("the compacted generation serves wrongly")
    return launches


class CappedFetchStore:
    """A host store whose fetches are held to at most `max_blocks` cluster
    blocks (the label pass's bounded-read contract); `peak` is the
    largest fetch."""

    is_host = True

    def __init__(self, store, max_blocks):
        self._store = store
        self.max_blocks = int(max_blocks)
        self.peak = 0

    @property
    def cluster_docs(self):
        return self._store.cluster_docs

    @property
    def block_bytes(self):
        return self._store.block_bytes

    def fetch_blocks(self, cluster_ids):
        n = len(np.asarray(cluster_ids).reshape(-1))
        self.peak = max(self.peak, n)
        if n > self.max_blocks:
            raise AssertionError(f"a fetch of {n} blocks, over the "
                                 f"{self.max_blocks} a chunk may read")
        return self._store.fetch_blocks(cluster_ids)


class _Tee(io.TextIOBase):
    """stdout for a CLI run in process: printed as it comes, and kept."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        return self.buf.write(s)

    def flush(self):
        self.out.flush()


def run_cli(main, argv):
    """(rc, stdout) of an in-process CLI run."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = main(argv)
    return rc, tee.buf.getvalue()


def serve_beside(path, qs, dev, stop):
    """A second engine over `path` serving batches on a thread until `stop`
    is set; it adopts each new generation by reload_selector() between
    batches. Returns (engine, thread, record)."""
    from repro_torch.index import IndexReader
    from repro_torch.index import format as fmt

    eng = IndexReader.open(path).engine(max_batch=MAX_BATCH, device=dev)
    rec = {"batches": 0, "failed": 0, "generations": [eng.reader.generation],
           "reload_s": []}

    def run():
        while not stop.is_set():
            try:
                ids, _ = eng.retrieve(*queries(qs, 0, MAX_BATCH))
                ids.cpu()
                rec["batches"] += 1
                if fmt.manifest_generation(fmt.load_manifest(path)) != \
                        eng.reader.generation:
                    t0 = time.perf_counter()
                    rec["generations"].append(eng.reload_selector())
                    rec["reload_s"].append(time.perf_counter() - t0)
            except Exception as e:       # counted, and gated by the caller
                rec["failed"] += 1
                rec["error"] = repr(e)
            stop.wait(0.05)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return eng, t, rec


def serve_mrr(path, qs, dev):
    """MRR@10 of the N_QUERIES queries through a fresh engine over path."""
    from repro_torch.data import mrr_at
    from repro_torch.index import IndexReader

    with IndexReader.open(path).engine(max_batch=MAX_BATCH,
                                       device=dev) as eng:
        ids, _ = eng.retrieve(*queries(qs, 0, N_QUERIES))
        return mrr_at(ids.cpu().numpy(), qs.rel_doc[:N_QUERIES])


def decoded_matrix(store, n_docs, dim, dev):
    """The (n_docs, dim) float matrix the store's live slots decode to, on
    `dev`, filled 512 clusters a fetch."""
    dec = torch.zeros((n_docs, dim), dtype=torch.float32, device=dev)
    for lo in range(0, store.n_clusters, 512):
        vecs, docs, valid = store.fetch_blocks(
            np.arange(lo, min(lo + 512, store.n_clusters)))
        valid = np.asarray(valid)
        rows = torch.from_numpy(np.asarray(docs)[valid].astype(np.int64))
        dec[rows.to(dev)] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(vecs)[valid])).to(dev)
    return dec


def label_gates(reader, cfg, store, sets, dev):
    """The streamed label sets against the in-RAM top-k over the decoded
    matrix on the card (isolated ranks), no deleted doc among them, and 16
    train queries recomputed on the CPU. Returns the holdout queries'
    in-RAM score rows (the topk kernel's (B, n_docs) input)."""
    from repro_torch import train as train_lib
    from repro_torch.core.clusd import full_dense_topk

    t0 = time.perf_counter()
    n_docs = int(reader.array("doc_cluster").shape[0])
    dec = decoded_matrix(store, n_docs, cfg.dim, dev)
    sync(dev)
    print(f"  decoded matrix {tuple(dec.shape)} on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    cd = np.asarray(reader.array("cluster_docs"))
    tomb = reader.tombstones()
    tomb = np.zeros(cd.shape, np.uint8) if tomb is None else tomb
    live = set(cd[(tomb == 0) & (cd >= 0)].tolist())
    dead = np.array(sorted(set(cd[tomb > 0].tolist()) - live), np.int64)
    hold_rows = None
    for tag, (q, ls) in sets.items():
        qd = torch.from_numpy(q.q_dense).to(dev)
        ids, sc = full_dense_topk(dec, qd, ls.dense_ids.shape[1])
        ids, sc = ids.cpu().numpy(), sc.cpu().numpy()
        ok = isolated_ranks(sc, PARITY_GAP)
        bad = int((ids[ok] != ls.dense_ids[ok]).sum())
        rows_eq = int((ids == ls.dense_ids).all(axis=1).sum())
        n_dead = int(np.isin(ls.dense_ids, dead).sum())
        print(f"  labels[{tag}]: streamed vs in-RAM top-{ids.shape[1]} over "
              f"the decoded matrix: {int(ok.sum())} of {ok.size} ranks "
              f"isolated, mismatches {bad}; rows bitwise equal {rows_eq} of "
              f"{len(ids)}; deleted ids among them {n_dead} (of "
              f"{len(dead)} deleted); pos_rate {ls.pos_rate:.4f}")
        if bad or n_dead:
            raise AssertionError(f"labels[{tag}] disagree with the in-RAM "
                                 "top-k or hold a deleted doc")
        if tag == "holdout":
            hold_rows = (qd @ dec.T).contiguous()
        if tag == "train":
            train_sc = sc
    del dec
    # 16 train queries streamed again on the CPU
    q, ls = sets["train"]
    _, index_cpu = reader.load_index(device="cpu")
    t0 = time.perf_counter()
    cls = train_lib.make_labels_streaming(
        cfg, index_cpu, store, q.q_dense[:16], q.q_terms[:16],
        q.q_weights[:16], label_cfg=train_lib.LabelConfig(
            chunk_clusters=TRAIN_CHUNK), device="cpu")
    ok = isolated_ranks(train_sc[:16], PARITY_GAP)
    bad = int((cls.dense_ids[ok] != ls.dense_ids[:16][ok]).sum())
    same = (cls.dense_ids == ls.dense_ids[:16]).all(axis=1)
    lab_bad = int((cls.labels[same] != ls.labels[:16][same]).sum())
    cand_eq = np.array_equal(cls.cand, ls.cand[:16])
    feat_err = float(np.abs(cls.feats - ls.feats[:16]).max())
    print(f"  16 train queries on the CPU ({time.perf_counter() - t0:.2f} "
          f"s): dense-id mismatches at isolated ranks {bad}; rows equal "
          f"{int(same.sum())}; label mismatches in them {lab_bad}; "
          f"candidates equal {cand_eq}; max |feature diff| {feat_err:.3g}")
    if bad or lab_bad or not cand_eq or feat_err > 1e-4:
        raise AssertionError("the CPU's labels disagree with the card's")
    return hold_rows


def trainer_gates(cfg, ls, dev, tmp):
    """One step's gradients and the first 20 steps' losses, card against
    CPU from the same params; resume on the card against a straight run.
    Returns the largest bucket's batch features (the train LSTM shape)."""
    from repro_torch import train as train_lib
    from repro_torch.optim import adamw_init
    from repro_torch.train import data as data_lib

    init = train_lib.trainer.init_selector_params(
        "lstm", ls.feats.shape[-1], cfg.lstm_hidden,
        torch.Generator().manual_seed(SEED + 5), "cpu")
    buckets = data_lib.bucket_lengths(cfg, ls.feats, ls.labels)
    per_epoch = data_lib.n_batches_per_epoch(buckets, MAX_BATCH)
    batches = [b for e in range(-(-20 // per_epoch) + 1)
               for b in data_lib.bucketed_batches(
                   ls.feats, ls.labels, buckets, batch_size=MAX_BATCH,
                   seed=SEED, epoch=e)][:20]
    big = max(batches, key=lambda b: b.length)
    losses, grads = {}, {}
    for d in ("cpu", dev):
        tr = train_lib.SelectorTrainer(cfg, device=d)
        p = {k: v.to(d) for k, v in init.items()}
        opt = adamw_init(p)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(d)  # noqa
        pos_w = torch.tensor(float(cfg.pos_weight), device=d)
        _, g = tr.loss_and_grads(p, t(big.feats), t(big.labels),
                                 t(big.weights), pos_w)
        grads[str(d)] = {k: v.cpu().numpy() for k, v in g.items()}
        out = []
        for b in batches:
            p, opt, loss = tr._step_fn(b.length)(
                p, opt, t(b.feats), t(b.labels), t(b.weights), pos_w)
            out.append(float(loss))
        losses[str(d)] = np.array(out)
    gerr = max(float(np.abs(grads[str(dev)][k] - grads["cpu"][k]).max())
               for k in grads["cpu"])
    g_ok = all(np.allclose(grads[str(dev)][k], grads["cpu"][k],
                           **TRAIN_TOL) for k in grads["cpu"])
    lrel = float(np.abs(losses[str(dev)] / losses["cpu"] - 1).max())
    print(f"  one step at {big.feats.shape}, card (kernel forward) vs CPU "
          f"(plain): max |grad diff| {gerr:.3g}, allclose(rtol "
          f"{TRAIN_TOL['rtol']}, atol {TRAIN_TOL['atol']}) {g_ok}; first "
          f"{len(batches)} steps' losses max relative diff {lrel:.3g} "
          f"(card {losses[str(dev)][0]:.6f} .. {losses[str(dev)][-1]:.6f})")
    if not g_ok or lrel > LOSS_RTOL:
        raise AssertionError("the card's training disagrees with the CPU's")
    # train N steps == train k, resume, train N - k, on the card
    kw = dict(epochs=2, seed=SEED)
    n = 2 * per_epoch
    k = per_epoch + max(1, per_epoch // 2) if per_epoch > 1 else 1
    full, _ = train_lib.SelectorTrainer(cfg, train_lib.SelectorTrainConfig(
        **kw), device=dev).fit(None, ls.feats, ls.labels, init=init)
    ck = os.path.join(tmp, "resume_ckpt")
    train_lib.SelectorTrainer(cfg, train_lib.SelectorTrainConfig(
        ckpt_dir=ck, max_steps=k, **kw), device=dev).fit(
        None, ls.feats, ls.labels, init=init)
    res, _ = train_lib.SelectorTrainer(cfg, train_lib.SelectorTrainConfig(
        ckpt_dir=ck, **kw), device=dev).fit(None, ls.feats, ls.labels,
                                            init=init, resume=True)
    same = all(torch.equal(full[key], res[key]) for key in full)
    print(f"  resume on the card: {n} steps straight vs {k} + resume + "
          f"{n - k}: bitwise {same}")
    if not same:
        raise AssertionError("resume on the card is not bitwise")
    shutil.rmtree(ck)
    return torch.from_numpy(np.ascontiguousarray(big.feats)).to(dev)


def calibration_gate(path, hold_q, hold_ls, dev):
    """The engine serves Stage II through the lstm_sequence kernel,
    so the calibration's probabilities must come from it. The engine's
    own Stage-I/II functions on the holdout queries against select_at on
    the calibration probabilities at the published (theta, budget)."""
    from repro_torch import train as train_lib
    from repro_torch.engine import pipeline as pipe_lib
    from repro_torch.index import IndexReader

    reader = IndexReader.open(path)
    cfg, index = reader.load_index(device=dev)
    params = reader.lstm_params()
    theta, budget = cfg.theta, cfg.max_selected
    probs = train_lib.selector_probs(params, hold_ls.feats, use_kernel=True,
                                     device=dev)
    sel_ids, sel_mask = train_lib.select_at(hold_ls.cand, probs, theta,
                                            budget)
    qd, qt, qw = (torch.from_numpy(a).to(dev) for a in
                  (hold_q.q_dense, hold_q.q_terms, hold_q.q_weights))
    with torch.no_grad():
        _, _, cand, feats = pipe_lib.build_stage1_fn(cfg, index)(qd, qt, qw)
        e_ids, e_mask, e_probs = pipe_lib.build_stage2_fn(cfg, index)(
            cand, feats)
    e_ids, e_mask = e_ids.cpu().numpy(), e_mask.cpu().numpy()
    e_probs = e_probs.cpu().numpy()
    near = (np.abs(probs - theta) < 1e-6).any(axis=1)
    diff = ((np.where(e_mask, e_ids, -1) != np.where(sel_mask, sel_ids, -1))
            .any(axis=1) | (cand.cpu().numpy() != hold_ls.cand).any(axis=1))
    bad = int((diff & ~near).sum())
    print(f"  calibration at the published theta {theta} budget {budget}: "
          f"engine Stage II vs select_at on the calibration probabilities: "
          f"{int(diff.sum())} of {len(diff)} queries differ, {bad} away "
          f"from theta; probs bitwise {np.array_equal(e_probs, probs)}, "
          f"max |diff| {float(np.abs(e_probs - probs).max()):.3g}; clusters "
          f"selected a query {e_mask.sum(1).mean():.2f}")
    if bad:
        raise AssertionError("the engine's Stage II disagrees with the "
                             "calibration")
    return {k: torch.from_numpy(v).to(dev) for k, v in params.items()}


def recsys_train(dev):
    """make_train_step on wide_deep at RECSYS_SIZE widths, TRAIN_RECSYS_STEPS
    batches of 512 on the card. Returns the wide bag's (table, idx) of the
    last batch."""
    from repro_torch.data import RecsysStream
    from repro_torch.models import recsys as rs
    from repro_torch.optim import adamw_init

    cfg, model = recsys_model(dev)
    params = model.params
    del model
    opt = adamw_init(rs.train_tree(params))
    step = rs.make_train_step(cfg)
    stream = RecsysStream(cfg, seed=SEED + 2)
    batches = [rs.as_batch(stream.batch(512), dev)
               for _ in range(TRAIN_RECSYS_STEPS)]
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for b in batches:
        t0 = time.perf_counter()
        params, opt, st = step(params, opt, b)
        losses.append(float(st["loss"]))       # syncs the step
        ms.append((time.perf_counter() - t0) * 1e3)
    p50, _, _ = _ms_stats(ms)
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    print(f"  {cfg.name} make_train_step, {len(batches)} steps at batch 512: "
          f"step ms p50 {p50:.3f} (first {ms[0]:.3f}, all "
          f"{[round(m, 3) for m in ms]}); losses {[round(x, 5) for x in losses]}"
          f"; peak device memory {peak:.2f} GB")
    if not np.isfinite(losses).all():
        raise AssertionError("the recsys train step gave a loss that is not "
                             "finite")
    wide = params["wide"]
    sparse = batches[-1]["sparse"]
    idx = (sparse + wide.offsets[:sparse.shape[1]]).contiguous()
    return wide.weight.detach(), idx, p50


def recsys_train_parity(dev):
    """One make_train_step at wide_deep smoke() widths, card against CPU:
    loss, gradients, params. Adam's first step moves each param by about
    lr whatever its gradient's size, so where |grad| < 1e-6 the two may
    step in opposite directions: held there at 2 lr."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import RecsysStream
    from repro_torch.models import recsys as rs
    from repro_torch.optim import adamw_init

    cfg = get_config("wide-deep", "smoke")
    params = rs.init_params(cfg, torch.Generator().manual_seed(SEED),
                            device="cpu")
    batch = RecsysStream(cfg, seed=SEED + 3).batch(512)
    step = rs.make_train_step(cfg)
    res = {}
    for d in ("cpu", dev):
        p = {k: v.moved(d) if isinstance(v, rs.FusedTable) else v.to(d)
             for k, v in params.items()}
        b = rs.as_batch(batch, d)
        loss, grads = rs.train_loss_and_grads(cfg, p, b)
        p2, _, _ = step(p, adamw_init(rs.train_tree(p)), b)
        res[str(d)] = (float(loss), {k: v.cpu().numpy() for k, v in
                                     grads.items()},
                       {k: v.cpu().numpy() for k, v in
                        rs.train_tree(p2).items()})
    c, g = res["cpu"], res[str(dev)]
    lr = TrainConfig().lr
    g_ok = all(np.allclose(g[1][k], c[1][k], **TRAIN_TOL) for k in c[1])
    p_bad = 0
    for k in c[2]:
        small = np.abs(c[1][k]) < 1e-6
        d = np.abs(g[2][k] - c[2][k])
        p_bad += int((d[~small] > 1e-5 + 1e-5 * np.abs(c[2][k][~small]))
                     .sum() + (d[small] > 2 * lr + 1e-6).sum())
    print(f"  wide_deep smoke one step card vs CPU: loss {g[0]:.7f} / "
          f"{c[0]:.7f}; grads allclose {g_ok} (max |diff| "
          f"{max(float(np.abs(g[1][k] - c[1][k]).max()) for k in c[1]):.3g})"
          f"; params outside tolerance {p_bad}")
    if not (abs(g[0] - c[0]) <= 1e-5 * abs(c[0]) and g_ok and p_bad == 0):
        raise AssertionError("the recsys train step on the card disagrees "
                             "with the CPU's")


def train_phase(v2_dir, qs, tmp, dev):
    """Selector training on the v2 directory as update_v2 left it: the
    label pass (streamed, capped reads, into the CLI's label cache),
    `repro_torch.launch.train_selector.main` with --publish beside a
    serving thread, again with --resume, the build_index CLI at its
    defaults, recsys make_train_step; then the gates. Returns (launch
    counts of the driven path, the kernels' train inputs)."""
    from types import SimpleNamespace

    from repro_torch import kernels
    from repro_torch import train as train_lib
    from repro_torch.data import synth_corpus, synth_queries
    from repro_torch.index import IndexReader
    from repro_torch.launch import build_index as build_cli
    from repro_torch.launch import train_selector as ts_cli

    reader = IndexReader.open(v2_dir)
    cfg, index = reader.load_index(device=dev)
    store = reader.open_store(cluster_docs=index.cluster_docs)
    t0 = time.perf_counter()
    _, train_q, hold_q = ts_cli._corpus_queries(reader, SimpleNamespace(
        seed=SEED, train_queries=TRAIN_QUERIES,
        holdout_queries=HOLDOUT_QUERIES))
    print(f"  generation {reader.generation}; the CLI's queries from the "
          f"directory's corpus recipe: {time.perf_counter() - t0:.2f} s")
    mrr_before = serve_mrr(v2_dir, qs, dev)

    kernels.reset_launches()
    lc = train_lib.LabelConfig(chunk_clusters=TRAIN_CHUNK)
    cache = train_lib.LabelCache(v2_dir.rstrip("/") + ".labels")
    sets = {}
    for tag, q in (("train", train_q), ("holdout", hold_q)):
        capped = CappedFetchStore(store, TRAIN_CHUNK)
        ls = train_lib.make_labels_streaming(
            cfg, index, capped, q.q_dense, q.q_terms, q.q_weights,
            label_cfg=lc, device=dev)
        key = train_lib.label_cache_key(
            reader.manifest, cfg, lc, train_lib.query_fingerprint(
                q.q_dense, q.q_terms, q.q_weights))
        cache.save(key, ls, extra={"tag": tag,
                                   "generation": reader.generation})
        st = ls.stats
        print(f"  label pass [{tag}] {ls.n_queries} queries: {st.wall_s:.2f} "
              f"s (stream {st.stream_wall_s:.2f} s), {st.n_fetches} fetches, "
              f"{st.blocks_read} blocks, {st.bytes_read} bytes; largest "
              f"fetch {capped.peak} <= {TRAIN_CHUNK} blocks")
        sets[tag] = (q, ls)
    train_ls = sets["train"][1]
    per_epoch = train_lib.n_batches_per_epoch(train_lib.bucket_lengths(
        cfg, train_ls.feats, train_ls.labels), MAX_BATCH)
    n_steps = cfg.epochs * per_epoch
    every = max(1, n_steps // 3)

    stop = threading.Event()
    eng, thread, rec = serve_beside(v2_dir, qs, dev, stop)
    trace = os.path.join(tmp, "train.jsonl")
    metrics = os.path.join(tmp, "train_metrics.json")
    argv = ["--index-dir", v2_dir, "--train-queries", str(TRAIN_QUERIES),
            "--holdout-queries", str(HOLDOUT_QUERIES), "--chunk-clusters",
            str(TRAIN_CHUNK), "--ckpt-every", str(every),
            "--device", str(dev)]
    t0 = time.perf_counter()
    rc, out = run_cli(ts_cli.main, argv + [
        "--publish", "--serve-check", str(TRAIN_SERVE_CHECK),
        "--trace-out", trace, "--metrics-out", metrics])
    sync(dev)
    cli_s = time.perf_counter() - t0
    deadline = time.perf_counter() + 120     # its next batch sees the commit
    while rec["generations"][-1] == 1 and not rec["failed"] and \
            time.perf_counter() < deadline:
        time.sleep(0.05)
    stop.set()
    thread.join()
    if rc != 0 or "serve check OK" not in out or out.count("(cache hit)") \
            != 2:
        raise AssertionError("the train_selector CLI failed")
    hot, _ = eng.retrieve(*queries(qs, 0, MAX_BATCH))
    eng.close()
    with IndexReader.open(v2_dir).engine(max_batch=MAX_BATCH,
                                         device=dev) as fresh:
        want, _ = fresh.retrieve(*queries(qs, 0, MAX_BATCH))
    print(f"  train_selector --publish: rc {rc} in {cli_s:.2f} s, {n_steps} "
          f"steps ({per_epoch} per epoch, a checkpoint every {every}); serving "
          f"thread: {rec['batches']} batches, {rec['failed']} failed, "
          f"generations {rec['generations']}, reload_selector "
          f"{[round(x, 3) for x in rec['reload_s']]} s; its ids after the "
          f"reload equal a fresh engine's {torch.equal(hot, want)}")
    if rec["failed"] or rec["generations"][-1] != 2 or not torch.equal(
            hot, want):
        raise AssertionError(f"serving beside the publish failed: {rec}")
    spans = {}
    with open(trace) as f:
        for ln in f:
            r = json.loads(ln)
            if r["trace_name"] == "train_selector":
                spans[r["span"]] = round(r["dur_ms"], 3)
    with open(metrics) as f:
        snap = json.load(f)
    hist = snap["histograms"]["train.step_ms"]
    print(f"  spans (ms) {json.dumps(spans)}; train.step_ms p50 "
          f"{hist.get('p50')} p99 {hist.get('p99')} over {hist['count']} "
          f"steps; train.steps_per_s {snap['gauges']['train.steps_per_s']}")
    t0 = time.perf_counter()
    rc, out = run_cli(ts_cli.main, argv + ["--resume"])
    print(f"  train_selector --resume: rc {rc} in "
          f"{time.perf_counter() - t0:.2f} s")
    if rc != 0 or out.count("(cache hit)") != 2 or "no steps left" not in out:
        raise AssertionError("the --resume run did not hit the label cache "
                             "or had steps left")

    bi = os.path.join(tmp, "build_index")
    t0 = time.perf_counter()
    rc, _ = run_cli(build_cli.main, ["--out", bi, "--device", str(dev)])
    bi_s = time.perf_counter() - t0
    r = IndexReader.open(bi, verify="full")
    meta = r.manifest["extra"]["corpus"]
    bq = synth_queries(SEED + 7, synth_corpus(meta["seed"], meta["n_docs"],
                                              meta["dim"], meta["vocab"]), 64)
    with r.engine(max_batch=64, device=dev) as beng:
        ids, scores = beng.retrieve(bq.q_dense, bq.q_terms, bq.q_weights)
        check_results(beng.cfg, ids, scores, 64)
    from repro_torch.data import mrr_at
    print(f"  build_index CLI at its defaults: rc {rc} in {bi_s:.2f} s, "
          f"{r.manifest['total_bytes']} bytes, lstm "
          f"{r.manifest['lstm'] is not None}; served 64 queries, MRR@10 "
          f"{mrr_at(ids.cpu().numpy(), bq.rel_doc):.4f}")
    if rc != 0 or r.manifest["lstm"] is None:
        raise AssertionError("the build_index CLI failed")
    shutil.rmtree(bi)
    table, idx, recsys_ms = recsys_train(dev)
    sync(dev)
    launches = dict(kernels.LAUNCHES)
    print(f"  train path launches {launches}")

    # the gates (their launches are not the path's)
    with torch.no_grad():
        hold_rows = label_gates(reader, cfg, store, sets, dev)
    x = trainer_gates(cfg, train_ls, dev, tmp)
    params = calibration_gate(v2_dir, hold_q, sets["holdout"][1], dev)
    recsys_train_parity(dev)
    mrr_after = serve_mrr(v2_dir, qs, dev)
    print(f"  MRR@10 of the {N_QUERIES} queries on v2: {mrr_before:.4f} "
          f"(generation 1, untrained selector) -> {mrr_after:.4f} "
          f"(generation 2, trained and calibrated; for information)")
    q_chunk = torch.from_numpy(train_q.q_dense).to(dev)
    vecs, _, _ = store.fetch_blocks(np.arange(TRAIN_CHUNK))
    chunk = torch.from_numpy(np.ascontiguousarray(vecs)).to(dev)
    return launches, {"lstm": (x, params), "chunk": (q_chunk, chunk),
                      "rows": hold_rows, "bag": (table, idx),
                      "recsys_step_ms": recsys_ms}


def check_train_kernels(rows, dev, t_in):
    """The train path's new shapes, each kernel against its plain version:
    lstm_sequence at the trainer's largest bucket (with the backward's
    time for information), cluster_score at the label chunk (beside q @
    blocks^T), topk over the in-RAM full-dense rows, and the embedding_bag
    backward against autograd through its plain version (with the wide
    bag's forward and forward + backward beside F.embedding_bag's, and
    their bounds). Appended to the rows' shapes."""
    from torch.nn.functional import embedding_bag as lib_bag

    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_ref)
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    from repro_torch.kernels.lstm import lstm_sequence, lstm_sequence_ref
    from repro_torch.kernels.topk import topk, topk_ref

    by = {r["name"]: r for r in rows}
    x, p = t_in["lstm"]
    (B, n, F), (H, G) = x.shape, p["wh"].shape
    out = lstm_sequence(x, p["wx"], p["wh"], p["b"])
    ref = lstm_sequence_ref(x, p["wx"], p["wh"], p["b"])
    e = (out - ref).abs().max().item()
    ins = [t.clone().requires_grad_() for t in (x, p["wx"], p["wh"], p["b"])]
    gout = torch.randn(out.shape, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
    g_k = torch.autograd.grad(lstm_sequence(*ins), ins, gout)
    g_r = torch.autograd.grad(lstm_sequence_ref(*ins), ins, gout)
    bitwise = all(torch.equal(a, b) for a, b in zip(g_k, g_r))
    if not e <= 1e-5 or not bitwise:
        raise AssertionError(f"lstm_sequence at the train shape: {e}, "
                             f"backward bitwise {bitwise}")
    fwd = graph_ms(lambda: lstm_sequence(x, p["wx"], p["wh"], p["b"]), 50)
    bwd = cuda_ms(lambda: torch.autograd.grad(lstm_sequence(*ins), ins,
                                              gout), 10)
    # one trainer step at this shape, alone on the card: the forward and
    # loss, the backward (the plain LSTM recomputed under autograd), Adam
    from repro_torch import train as train_lib
    from repro_torch.configs import clusd_msmarco
    from repro_torch.optim import adamw_init, adamw_update
    tr = train_lib.SelectorTrainer(clusd_msmarco.full(), device=dev)
    y = (torch.rand(B, n, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
         < 0.05).float()
    w, pw = torch.ones(B, device=dev), torch.tensor(4.0, device=dev)
    opt = adamw_init(p)

    def fwd_loss():
        with torch.no_grad():
            probs = torch.clamp(train_lib.selector_apply(p, x,
                                                         use_kernel=True),
                                1e-6, 1 - 1e-6)
            return -(pw * y * torch.log(probs)
                     + (1 - y) * torch.log(1 - probs)).mean()

    def step():
        _, grads = tr.loss_and_grads(p, x, y, w, pw)
        return adamw_update(grads, opt, p, lr=1e-3)

    t_fwd, t_lg, t_step = (cuda_ms(fwd_loss, 10),
                           cuda_ms(lambda: tr.loss_and_grads(p, x, y, w, pw),
                                   10), cuda_ms(step, 10))
    b_ms, b_by = bound(4 * (x.numel() + F * G + H * G + G + B * n * H),
                       2 * B * n * G * (F + H))
    by["lstm_sequence"]["shapes"].append(
        f"train (B, n, F, H) {(B, n, F, H)}: ms {fwd:.4f} plain "
        f"{cuda_ms(lambda: lstm_sequence_ref(x, p['wx'], p['wh'], p['b']), 10):.4f}"
        f" bound {b_ms:.4f} ({b_by}); forward + backward (plain VJP "
        f"recomputed) eager {bwd:.4f}; max_abs_err {e:.3g}; backward "
        f"bitwise autograd through plain; a trainer step alone {t_step:.4f}"
        f" (forward + loss {t_fwd:.4f}, + backward {t_lg:.4f}, Adam "
        f"{t_step - t_lg:.4f}; the backward's share "
        f"{(t_lg - t_fwd) / t_step:.3f})")
    q, blocks = t_in["chunk"]
    U, cap, dim = blocks.shape
    sel = torch.arange(U, dtype=torch.int32, device=dev)[None].expand(
        q.shape[0], U).contiguous()
    flat = blocks.reshape(U * cap, dim)
    by["cluster_score"]["shapes"].append(cluster_score_case(
        "train: label chunk (library q @ blocks^T)", q, blocks, sel,
        lambda: q @ flat.T)["note"])
    xr = t_in["rows"]
    v, i = topk(xr, 10)
    rv, ri = topk_ref(xr, 10)
    if not (torch.equal(i, ri) and torch.equal(v.view(torch.int32),
                                               rv.view(torch.int32))):
        raise AssertionError("topk on the full-dense rows is not bitwise")
    Bq, D = xr.shape
    b_ms, b_by = bound(4 * Bq * D + 12 * Bq * 10, Bq * D)
    by["topk"]["shapes"].append(
        f"full-dense ({Bq}, {D}) k 10: ms "
        f"{graph_ms(lambda: topk(xr, 10)):.4f} plain "
        f"{cuda_ms(lambda: topk_ref(xr, 10), 3):.4f} library "
        f"{graph_ms(lambda: torch.topk(xr, 10), 5):.4f} bound {b_ms:.4f} "
        f"({b_by})")
    table, idx = t_in["bag"]
    gout = torch.randn((idx.shape[0], table.shape[1]), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(2))
    tk = table.clone().requires_grad_()
    tr = table.clone().requires_grad_()
    (gk,) = torch.autograd.grad(embedding_bag(tk, idx), tk, gout)
    (gr,) = torch.autograd.grad(embedding_bag_ref(tr, idx), tr, gout)
    e = (gk - gr).abs().max().item()
    # index_add_'s atomics add a row's duplicates in another order
    if not torch.allclose(gk, gr, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"embedding_bag's backward disagrees: {e}")
    # the launch alone and the library's forward (F.embedding_bag) and
    # forward + backward through autograd; the forward's bound (the
    # distinct rows read, the indices, the output) and sector floor, and
    # the backward's bytes beside (the output's gradient read, the dense
    # table gradient written)
    (B, hot), (V, d), es = idx.shape, table.shape, table.element_size()
    out = torch.empty((B, d), dtype=table.dtype, device=dev)
    word = torch.zeros(1, dtype=torch.int64, device=dev)
    tl = table.clone().requires_grad_()
    io = 4 * idx.numel() + es * B * d
    read = es * torch.unique(idx).numel() * d
    f_ms, f_by = bound(read + io, B * hot * d)
    fb_ms, fb_by = bound(read + io + 4 * B * d + es * V * d, 2 * B * hot * d)
    by["embedding_bag"]["shapes"].append(
        f"train wide bag (B, hot, d) {(B, hot, d)} over {V} rows: forward "
        f"ms {graph_ms(lambda: eb_kernel.embedding_bag_cuda(table, idx, out, word)):.4f}"
        f" (wrapper {cuda_ms(lambda: embedding_bag(table, idx), 20):.4f}) "
        f"library {graph_ms(lambda: lib_bag(idx, table, mode='sum')):.4f}"
        f" bound {f_ms:.3g} ({f_by}) sector floor "
        f"{(32 * table_sectors(table, idx) + io) / HBM_BYTES_PER_S * 1e3:.3g}"
        f"; forward + backward eager "
        f"{cuda_ms(lambda: torch.autograd.grad(embedding_bag(tk, idx), tk, gout), 10):.4f}"
        f" plain's {cuda_ms(lambda: torch.autograd.grad(embedding_bag_ref(tr, idx), tr, gout), 5):.4f}"
        f" library's {cuda_ms(lambda: torch.autograd.grad(lib_bag(idx, tl, mode='sum'), tl, gout), 10):.4f}"
        f" bound {fb_ms:.4f} ({fb_by}); max |grad diff| {e:.3g}")
    for name in ("lstm_sequence", "cluster_score", "topk", "embedding_bag"):
        print(f"  {name}: {by[name]['shapes'][-1]}", flush=True)


# -- the distributed path and the router path ------------------------------

LSTM_KEYS = ("wx", "wh", "b", "head_w", "head_b")


def stage_distributed(cfg, index, emb_path, qs, tmp, dev):
    """Phase 5b, while the device InMemoryStore's index is alive: the files
    the distributed ranks read (the index arrays they need, the untrained
    selector's params, the first DIST_QUERIES queries, all np.save-d under
    tmp/dist), then the single-host references on `dev`: clusd.retrieve's
    ids for the overlap gate, and the same serve step run as one rank
    (a 1 x 1 mesh over the InMemoryStore's (N, cap, dim) block table,
    which is the blocked layout). Returns the job directory."""
    from repro_torch.core import clusd as clusd_lib
    from repro_torch.core import distributed as tdd

    job = os.path.join(tmp, "dist")
    os.makedirs(job)
    sp = index.sparse_index
    arrays = {"cluster_docs": index.cluster_docs, "centroids": index.centroids,
              "neighbor_ids": index.neighbor_ids,
              "neighbor_sims": index.neighbor_sims,
              "postings_docs": sp.postings_docs,
              "postings_weights": sp.postings_weights,
              **{f"sel_{k}": p for k, p in index.selector.named_parameters()}}
    for name, t in arrays.items():
        np.save(os.path.join(job, name + ".npy"), t.detach().cpu().numpy())
    for name, x in zip(("q_dense", "q_terms", "q_weights"),
                       queries(qs, 0, DIST_QUERIES)):
        np.save(os.path.join(job, name + ".npy"), np.asarray(x))
    with open(os.path.join(job, "job.json"), "w") as f:
        json.dump({"cfg": dataclasses.asdict(cfg), "emb_path": emb_path,
                   "n_docs": cfg.n_docs, "dim": cfg.dim}, f)
    q3 = [torch.as_tensor(np.asarray(x)).to(dev)
          for x in queries(qs, 0, DIST_QUERIES)]
    with torch.inference_mode():
        ids, _, _ = clusd_lib.retrieve(cfg, index, q3[0].float(),
                                       q3[1].int(), q3[2].float())
        np.save(os.path.join(job, "ref_clusd_ids.npy"), ids.cpu().numpy())
        _, o2n = tdd.blocked_ids(index.cluster_docs, cfg.n_docs)
        pd, pw = tdd.postings_by_owner(
            tdd.renumber_postings(sp.postings_docs, o2n),
            sp.postings_weights, cfg.n_clusters, cfg.cluster_cap, 1)
        # the InMemoryStore's block table is the blocked layout
        one = tdd.ServeRunner(cfg, tdd.ServeMesh(1, 1),
                              clusd_lib._device_store(index).blocks, pd, pw,
                              index.centroids, index.neighbor_ids,
                              index.neighbor_sims, index.selector,
                              device=dev)
        one(*queries(qs, 0, DIST_QUERIES))              # first use
        sync(dev)
        t0 = time.perf_counter()
        ids, scores = one(*queries(qs, 0, DIST_QUERIES))
        sync(dev)
        one_ms = (time.perf_counter() - t0) * 1e3
        np.save(os.path.join(job, "ref_one_ids.npy"), ids.cpu().numpy())
        np.save(os.path.join(job, "ref_one_scores.npy"),
                scores.cpu().numpy())
    del one
    index._stores.clear()
    print(f"  staged {len(arrays) + 3} arrays for {DIST_RANKS} ranks in "
          f"{job}; clusd.retrieve and the step as one rank over "
          f"{DIST_QUERIES} queries (one rank: {one_ms:.3f} ms)", flush=True)
    return job


def dist_rank(rank, world, job, dev_kind):
    """One of the distributed path's gloo ranks (a process of its own; a
    FileStore in the job directory). It builds its blocked slice from the
    staged embeddings file (np.memmap) and its postings by owner, serves
    the DIST_QUERIES queries through ServeRunner on a 1 x world mesh on
    `dev_kind` (warm-up, then DIST_REPS timed steps with the launch
    counts zeroed before them), takes the recsys guide row's top-k with
    local_topk and without, runs its CPU twin over the first
    DIST_PARITY_QUERIES queries, and saves its results in the job
    directory."""
    import torch.distributed as tdist

    from repro_torch import kernels
    from repro_torch.configs import CluSDConfig
    from repro_torch.convert import selector_from_numpy
    from repro_torch.core import distributed as tdd
    from repro_torch.core import retrieval as tret

    dev = torch.device(dev_kind)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    with open(os.path.join(job, "job.json")) as f:
        meta = json.load(f)

    def arr(name):
        return np.load(os.path.join(job, name + ".npy"), mmap_mode="r")

    tdist.init_process_group(
        "gloo", store=tdist.FileStore(os.path.join(job, "store"), world),
        rank=rank, world_size=world)
    try:
        cfg = CluSDConfig(**{**meta["cfg"], "bins": tuple(meta["cfg"]["bins"])})
        mesh = tdd.make_mesh(1, world)
        t0 = time.perf_counter()
        cd = np.asarray(arr("cluster_docs"))
        N, cap = cd.shape
        lo = rank * (N // world)
        emb = np.memmap(meta["emb_path"], dtype=np.float32, mode="r",
                        shape=(meta["n_docs"], meta["dim"]))
        _, o2n = tdd.blocked_ids(cd, meta["n_docs"])
        blocks = tdd.blocked_blocks(emb, cd, lo, lo + N // world)
        pd, pw = tdd.postings_by_owner(
            tdd.renumber_postings(arr("postings_docs"), o2n),
            arr("postings_weights"), N, cap, world)
        params = {k: np.asarray(arr(f"sel_{k}")) for k in LSTM_KEYS}
        layout_s = time.perf_counter() - t0
        args = (blocks, pd, pw, np.asarray(arr("centroids")),
                np.asarray(arr("neighbor_ids")),
                np.asarray(arr("neighbor_sims")))
        runner = tdd.ServeRunner(cfg, mesh, *args,
                                 selector_from_numpy(params, device=dev),
                                 device=dev)
        q3 = [np.asarray(arr(n)) for n in ("q_dense", "q_terms",
                                           "q_weights")]
        # the merge top-k's (B, n_model * kk) input, captured on the
        # warm-up step (its launches are not counted)
        real = tdd.topk_desc_index_asc
        width = world * min(cfg.k_sparse, N // world * cap)
        merge_in = []
        tdd.topk_desc_index_asc = lambda x, k: (
            merge_in.append(x.clone()) if x.shape[-1] == width
            and not merge_in else None, real(x, k))[1]
        # and the rank's cluster_score input (its owned blocks, the
        # positions with the other ranks' clusters clamped)
        real_cs, cs_in = tdd.cluster_score, []
        tdd.cluster_score = lambda *a: (cs_in.append(a), real_cs(*a))[1]
        try:
            runner(*q3)
        finally:
            tdd.topk_desc_index_asc = real
            tdd.cluster_score = real_cs
        sync(dev)
        kernels.reset_launches()
        ms = []
        for _ in range(DIST_REPS):
            tdist.barrier()
            t0 = time.perf_counter()
            ids, scores = runner(*q3)
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        g = torch.from_numpy(np.asarray(arr("guide_row"))).to(dev)
        spec = tret.CandidateIndexSpec(n_candidates=g.shape[0],
                                       n_clusters=int(meta["guide_clusters"]),
                                       cap=int(meta["guide_cap"]),
                                       k_guide=int(meta["k_guide"]),
                                       local_topk=True)
        lv, li = tret._guide_topk(g, spec)
        sync(dev)
        launches = dict(kernels.LAUNCHES)
        # rank 0 times cluster_score on its own input while the others wait
        tdist.barrier()
        cs = None
        if rank == 0 and dev.type == "cuda":
            q_c, blocks_c, sel_c = cs_in[0]
            cs = cluster_score_case("distributed rank 0", q_c, blocks_c,
                                    sel_c, gathered_einsum(q_c, blocks_c,
                                                           sel_c))
        tdist.barrier()
        gv, gi = tret._guide_topk(g, dataclasses.replace(spec,
                                                         local_topk=False))
        guide_equal = bool(torch.equal(li, gi) and torch.equal(
            lv.view(torch.int32), gv.view(torch.int32)))
        # the CPU twin on the first DIST_PARITY_QUERIES queries
        cpu = tdd.ServeRunner(cfg, mesh, *args,
                              selector_from_numpy(params, device="cpu"),
                              device="cpu")
        n = DIST_PARITY_QUERIES
        c_ids, c_sc = cpu(*[x[:n] for x in q3])
        np.savez(os.path.join(job, f"rank{rank}.npz"), ids=ids.cpu().numpy(),
                 scores=scores.cpu().numpy(), cpu_ids=c_ids.numpy(),
                 cpu_scores=c_sc.numpy(),
                 merge_in=merge_in[0].cpu().numpy() if rank == 0
                 else np.zeros(0, np.float32))
        with open(os.path.join(job, f"rank{rank}.json"), "w") as f:
            json.dump({"ms": ms, "launches": launches, "layout_s": layout_s,
                       "blocks_bytes": int(blocks.nbytes),
                       "p_shard": int(pd.shape[2]),
                       "guide_equal": guide_equal, "cluster_score": cs}, f)
    finally:
        tdist.destroy_process_group()


def distributed_phase(job, guide, dev):
    """The distributed path: DIST_RANKS processes (torch.multiprocessing,
    spawn) on the one card, a gloo group (NCCL refuses two ranks on one
    GPU; the gathers stage the (B, kk) values and ids through host
    memory). Gates: every rank returns the same rows; each rank's card
    output equals its CPU twin's on DIST_PARITY_QUERIES (ids at isolated
    ranks, scores rtol 1e-5, atol 1e-6); overlap@10 with the single-host
    clusd.retrieve above 0.9 (tests/test_distributed.py's bar); the
    guide top-k with local_topk equal to the global one on the recsys
    guide row. Against the same step run as one rank it prints the
    overlap (the one rank's kd top-k spans every selected slot, the four
    ranks' each their own: two lists of dense candidates, not one).
    Rank 0 also holds cluster_score to its plain version on its own
    input (cluster_score_case, after its launches are read). Returns (the
    summed launches of the ranks' timed steps and guide top-k, the merge
    top-k's input of rank 0, rank 0's cluster_score numbers or None off
    the card)."""
    import torch.multiprocessing as tmp

    row, k_guide, n_clusters, cap = guide
    np.save(os.path.join(job, "guide_row.npy"), row.cpu().numpy())
    with open(os.path.join(job, "job.json")) as f:
        meta = json.load(f)
    meta.update(k_guide=k_guide, guide_clusters=n_clusters, guide_cap=cap)
    with open(os.path.join(job, "job.json"), "w") as f:
        json.dump(meta, f)
    t0 = time.perf_counter()
    tmp.spawn(dist_rank, args=(DIST_RANKS, job, str(dev)),
              nprocs=DIST_RANKS, join=True)
    print(f"  {DIST_RANKS} ranks spawned, ran and joined in "
          f"{time.perf_counter() - t0:.2f} s")
    res = [dict(np.load(os.path.join(job, f"rank{r}.npz")))
           for r in range(DIST_RANKS)]
    info = []
    for r in range(DIST_RANKS):
        with open(os.path.join(job, f"rank{r}.json")) as f:
            info.append(json.load(f))
    for r in res[1:]:
        if not (np.array_equal(r["ids"], res[0]["ids"])
                and r["scores"].tobytes() == res[0]["scores"].tobytes()):
            raise AssertionError("the model ranks returned different rows")
    n = DIST_PARITY_QUERIES
    ok = isolated_ranks(res[0]["cpu_scores"], PARITY_GAP)
    bad = int((res[0]["ids"][:n][ok] != res[0]["cpu_ids"][ok]).sum())
    close = np.allclose(res[0]["scores"][:n], res[0]["cpu_scores"],
                        rtol=1e-5, atol=1e-6)
    print(f"  card vs CPU twin on {n} queries: ranks compared "
          f"{int(ok.sum())} of {ok.size}; id mismatches {bad}; scores "
          f"allclose(rtol 1e-5, atol 1e-6) {close}; max |score diff| "
          f"{np.abs(res[0]['scores'][:n] - res[0]['cpu_scores']).max():.3g}")
    from repro_torch.core import distributed as tdd
    cd = np.load(os.path.join(job, "cluster_docs.npy"))
    _, o2n = tdd.blocked_ids(cd, meta["n_docs"])
    n2o = np.full(cd.size + 1, -1, np.int64)     # the sentinel maps to -1
    n2o[o2n[o2n >= 0]] = np.nonzero(o2n >= 0)[0]
    ids_orig = n2o[res[0]["ids"]]
    ref = np.load(os.path.join(job, "ref_clusd_ids.npy"))
    overlap = float(np.mean([len(set(ids_orig[b, :10]) & set(ref[b, :10]))
                             / 10 for b in range(len(ref))]))
    one = np.load(os.path.join(job, "ref_one_ids.npy"))
    one_sc = np.load(os.path.join(job, "ref_one_scores.npy"))
    one_overlap = float(np.mean([len(set(res[0]["ids"][b, :10])
                                     & set(one[b, :10])) / 10
                                 for b in range(len(one))]))
    same_rows = int(sum(np.array_equal(res[0]["ids"][b], one[b])
                        and res[0]["scores"][b].tobytes()
                        == one_sc[b].tobytes() for b in range(len(one))))
    ms = np.asarray([m for i in info for m in i["ms"]])
    launches = {k: sum(i["launches"][k] for i in info)
                for k in info[0]["launches"]}
    print(f"  step over {DIST_QUERIES} queries: ms per rank "
          f"{[[round(m, 3) for m in i['ms']] for i in info]}; p50 "
          f"{np.percentile(ms, 50):.3f}; blocks per rank "
          f"{info[0]['blocks_bytes']} bytes; P_shard {info[0]['p_shard']}; "
          f"layout built in {max(i['layout_s'] for i in info):.2f} s")
    print(f"  overlap@10 with clusd.retrieve {overlap:.4f} (gate > 0.9); "
          f"with the step as one rank {one_overlap:.4f}, rows equal bit "
          f"for bit {same_rows} of {len(one)} (for information); guide "
          f"top-k with local_topk equal to the global on every rank "
          f"{all(i['guide_equal'] for i in info)}; launches {launches}")
    if bad or not close:
        raise AssertionError("distributed: card and CPU disagree")
    if not overlap > 0.9:
        raise AssertionError(f"distributed overlap@10 {overlap} <= 0.9")
    if not all(i["guide_equal"] for i in info):
        raise AssertionError("local_topk guide top-k != the global one")
    return (launches, torch.from_numpy(res[0]["merge_in"]).to(dev),
            info[0]["cluster_score"])


def _get(port, path):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def router_cli(v2_dir, tmp, dev):
    """The serve CLI in process on the card over v2, --hosts 4
    --replication 2 --kill-host 1 --check-parity, its live endpoint
    scraped while it serves (--serve-seconds keeps it up): /healthz 200,
    then /metrics with router_hosts_alive 3 once host 1 is down. Gates:
    exit 0, parity OK, failed=0, failovers > 0, every host's lane in the
    Chrome trace."""
    from repro_torch.launch import serve as serve_cli

    trace = os.path.join(tmp, "router_trace.json")
    argv = ["--index-dir", v2_dir, "--hosts", "4", "--replication", "2",
            "--kill-host", "1", "--check-parity", "--queries",
            str(N_QUERIES), "--batch", str(MAX_BATCH), "--metrics-port", "0",
            "--trace-out", trace, "--explain-out",
            os.path.join(tmp, "router_explain.jsonl"), "--serve-seconds",
            str(ROUTER_SERVE_SECONDS), "--device", str(dev)]
    tee, result = _Tee(sys.stdout), {}

    def run():
        with contextlib.redirect_stdout(tee):
            result["rc"] = serve_cli.main(argv)

    t0 = time.perf_counter()
    th = threading.Thread(target=run)
    th.start()
    port, health, metrics = None, None, ""
    deadline = time.monotonic() + 600
    while th.is_alive() and time.monotonic() < deadline:
        m = re.search(r"127\.0\.0\.1:(\d+)/metrics", tee.buf.getvalue())
        if m and port is None:
            port = int(m.group(1))
        if port is not None and "router_hosts_alive 3" not in metrics:
            health = health or _get(port, "/healthz")[0]
            code, metrics = _get(port, "/metrics")
        time.sleep(0.2)
    th.join()
    out = tee.buf.getvalue()
    lanes = {ev["tid"] for ev in json.load(open(trace))["traceEvents"]
             if (ev.get("args") or {}).get("host") is not None}
    hosts = {int(str(t).rsplit(".host", 1)[1]) for t in lanes}
    fo = re.search(r"failovers=(\d+)", out)
    print(f"  serve CLI: rc {result.get('rc')} in "
          f"{time.perf_counter() - t0:.2f} s; /healthz {health}; "
          f"router_hosts_alive 3 scraped {'router_hosts_alive 3' in metrics}"
          f"; host lanes {sorted(hosts)}")
    if result.get("rc") != 0 or "parity OK" not in out or "failed=0" \
            not in out or not fo or int(fo.group(1)) == 0 or health != 200 \
            or "router_hosts_alive 3" not in metrics or hosts != {0, 1, 2, 3}:
        raise AssertionError("the serve CLI's router gates failed")


def router_phase(dirs, qs, tmp, dev):
    """The router path. The serve CLI (router_cli), then on the card:
    over v2 at 4 hosts with R 1 and R 2, ids and scores bitwise a
    single-host engine on the N_QUERIES queries (R 2 served twice, the
    second pass traced and timed); v1 ("dot" hosts, cluster_score) on one
    batch, bitwise; R 1 with host 1 killed bitwise a placement without its
    shards; a rolling reload_index across a generation committed by the
    update path (write_index_delta) while a second thread serves (0
    failed batches, one generation per batch, ids after the hop equal a
    fresh engine's). Returns (the launches of the R 2 runs and the v1
    batch, the kernel checks' inputs: one host's adc_score_blocks
    arguments and one "dot" host's cluster_score arguments)."""
    from repro_torch import kernels
    from repro_torch.engine import ShardPlacement, ShardRouter
    from repro_torch.index import IndexReader, write_index_delta
    from repro_torch.launch.update_index import synth_delta

    v2, v1 = dirs["v2"], dirs["v1"]
    router_cli(v2, tmp, dev)

    def engine_out(path, n, show=False):
        with IndexReader.open(path).engine(max_batch=MAX_BATCH,
                                           prefetch=False, device=dev) as e:
            out = [t.cpu().numpy() for t in e.retrieve(*queries(qs, 0, n))]
            if show:
                st = e.stats()
                print(f"  single-host v2 engine (no prefetch) on generation "
                      f"{st['generation']}, the same {n} queries: batch p50 "
                      f"{st['p50_ms']} ms p99 {st['p99_ms']} ms qps_steady "
                      f"{st['qps_steady']}")
            return out

    def bitwise(got, want, what):
        got = [t.cpu().numpy() for t in got]
        if not all(g.tobytes() == w.tobytes() for g, w in zip(got, want)):
            bad = int((got[0] != want[0]).any(axis=1).sum())
            raise AssertionError(f"{what}: {bad} rows differ from the "
                                 "single-host engine")

    ref = engine_out(v2, N_QUERIES, show=True)
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    host_in = {}
    for repl in (1, 2):
        with ShardRouter.local(IndexReader.open(v2), 4, repl,
                               max_batch=MAX_BATCH, device=dev) as router:
            if repl == 2:
                kernels.reset_launches()
            bitwise(router.retrieve(*queries(qs, 0, N_QUERIES)), ref,
                    f"v2 router R {repl}")
            if repl == 1:
                continue
            router.reset_stats()
            router.tracer.sample_rate = 1.0
            real = router.hosts[0].submit
            router.hosts[0].submit = lambda req: (
                host_in.update(req=req), real(req))[1]
            bitwise(router.retrieve(*queries(qs, 0, N_QUERIES)), ref,
                    "v2 router R 2, second pass")
            sync(dev)
            for k, v in kernels.LAUNCHES.items():
                launches[k] += v
            st = router.stats()
            tot = router.tracer.span_totals("batch", skip_root=False)
            share = {k: round(tot[k]["ms"] / tot["batch"]["ms"], 4)
                     for k in ("stage1", "lut_build", "stage2_select",
                               "scatter", "gather", "merge", "fuse")}
            print(f"  v2 router, 4 hosts R 2, second pass of {N_QUERIES}: "
                  f"batch p50 {st['p50_ms']} ms p99 {st['p99_ms']} ms "
                  f"qps_steady {st['qps_steady']}; per host served "
                  f"{[h['served'] for h in st['per_host']]} cache hit rate "
                  f"{[round(h['cache']['hit_rate'], 4) for h in st['per_host']]}"
                  f"; span shares of a batch {json.dumps(share)}")
            gen = router.hosts[0]._gens[router._generation]
    # host 0's kernel input of its last request, as its _serve makes it
    req = host_in["req"]
    from repro_torch.engine import pipeline as pipe_lib
    uniq = np.asarray(req.uniq, np.int64)
    codes = pipe_lib.fetch_unique_code_blocks(gen.store, uniq)
    mine = np.asarray(req.mine, bool)
    sc = 1
    while sc < max(int(mine.sum(axis=1).max()), 1):
        sc *= 2
    sel = np.asarray(req.sel_ids)
    if sc < sel.shape[1]:
        keep = np.argsort(~mine, axis=1, kind="stable")[:, :sc]
        sel = np.take_along_axis(sel, keep, axis=1)
        mine = np.take_along_axis(mine, keep, axis=1)
    pos = np.searchsorted(uniq, np.where(mine, sel, uniq[0]))
    host_args = (torch.from_numpy(np.array(req.q_or_lut)).to(dev),
                 torch.from_numpy(codes).to(dev),
                 torch.from_numpy(pos.astype(np.int32)).to(dev))
    # v1: "dot" hosts, one batch
    ref1 = engine_out(v1, MAX_BATCH)
    dot_in = {}
    with ShardRouter.local(IndexReader.open(v1), 4, 2, max_batch=MAX_BATCH,
                           device=dev) as router:
        for h in router.hosts:       # the first "dot" host's input
            h._score = (lambda real: lambda gen, mode, x, b, p: (
                dot_in.setdefault("args", (x, b, p)),
                real(gen, mode, x, b, p))[1])(h._score)
        kernels.reset_launches()
        t0 = time.perf_counter()
        bitwise(router.retrieve(*queries(qs, 0, MAX_BATCH)), ref1,
                "v1 router")
        sync(dev)
        v1_s = time.perf_counter() - t0
        for k, v in kernels.LAUNCHES.items():
            launches[k] += v
    # R 1, host 1 killed == no replica for its shards
    n_shards = IndexReader.open(v2).n_block_shards()
    with ShardRouter.local(IndexReader.open(v2), 4, 1, max_batch=MAX_BATCH,
                           device=dev) as router:
        router.retrieve(*queries(qs, 0, MAX_BATCH))
        router.hosts[1].kill()
        t0 = time.perf_counter()
        got = router.retrieve(*queries(qs, 0, MAX_BATCH))
        sync(dev)
        kill_ms = (time.perf_counter() - t0) * 1e3
        st = router.stats()
    left = [0, 2, 3]                     # the hosts still up, renumbered
    pl = ShardPlacement(n_shards, 3, 1, replicas={
        s: ([] if s % 4 == 1 else [left.index(s % 4)])
        for s in range(n_shards)})
    with ShardRouter.local(IndexReader.open(v2), 3, placement=pl,
                           max_batch=MAX_BATCH, device=dev) as router:
        bitwise(got, [t.cpu().numpy() for t in router.retrieve(
            *queries(qs, 0, MAX_BATCH))], "R 1 with host 1 killed")
    print(f"  v1 router batch ({MAX_BATCH} queries, 4 hosts R 2): "
          f"{v1_s:.2f} s; R 1 kill-host batch {kill_ms:.3f} ms, missing "
          f"shards {st['missing_shards']}, degraded "
          f"{st['degraded_requests']}, bitwise a placement without them")
    # a rolling reload across a committed generation under serving
    with ShardRouter.local(IndexReader.open(v2), 4, 2, max_batch=MAX_BATCH,
                           device=dev) as router:
        old = router.stats()["generation"]
        rec, stop = {"batches": 0, "failed": 0}, threading.Event()

        def serve():
            while not stop.is_set():
                try:
                    router.retrieve(*queries(qs, 0, MAX_BATCH))[0].cpu()
                    rec["batches"] += 1
                except Exception as e:
                    rec["failed"] += 1
                    rec["error"] = repr(e)

        th = threading.Thread(target=serve)
        th.start()
        try:
            t0 = time.perf_counter()
            delta, _ = synth_delta(router.reader, ROUTER_UPSERTS,
                                   ROUTER_DELETES, seed=2)
            write_index_delta(v2, delta, verify="none", device=dev)
            commit_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            new = router.reload_index()
            reload_s = time.perf_counter() - t0
            router.retrieve(*queries(qs, 0, MAX_BATCH))
        finally:
            stop.set()
            th.join()
        gens = {m["generation"] for m in router.last_batches}
        got = router.retrieve(*queries(qs, 0, MAX_BATCH))
        st = router.stats()
    bitwise(got, engine_out(v2, MAX_BATCH), "router after the hop")
    print(f"  rolling reload {old} -> {new}: commit {commit_s:.2f} s, "
          f"reload_index {reload_s:.3f} s; {rec['batches']} batches beside, "
          f"{rec['failed']} failed; generations served {sorted(gens)}; "
          f"failed_requests {st['failed_requests']}")
    if rec["failed"] or st["failed_requests"] or new != old + 1 \
            or not gens <= {old, new}:
        raise AssertionError(f"the rolling reload failed: {rec}")
    x, b, p = dot_in["args"]
    host_dot = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (x, b, p.astype(np.int32)))
    return launches, (host_args, host_dot)


def check_router_kernels(rows, dev, host_args, merge_in, k, dist_cs):
    """The slice's new shapes against the plain versions: one router
    host's adc_score_blocks (its LUT, its own unique code blocks, its
    compacted positions) and cluster_score (a "dot" host's queries,
    unique float blocks and positions), the distributed step's (B,
    n_model * kk) merge top-k (rank 0's gathered values), and rank 0's
    cluster_score numbers (`dist_cs`, taken in its process). Appended to
    the rows' shapes."""
    from repro_torch.kernels.adc import adc_score_blocks, adc_score_blocks_ref
    from repro_torch.kernels.topk import topk, topk_ref

    host_args, host_dot = host_args
    by = {r["name"]: r for r in rows}
    q, blocks, sel = host_dot
    by["cluster_score"]["shapes"] += [
        cluster_score_case("router host", q, blocks, sel,
                           gathered_einsum(q, blocks, sel))["note"],
        dist_cs["note"]]
    del host_dot, q, blocks, sel
    lut, codes, sel = host_args
    out = adc_score_blocks(lut, codes, sel)
    ref = adc_score_blocks_ref(lut, codes, sel)
    if not torch.equal(out, ref):
        raise AssertionError("adc_score_blocks at the router host's shape "
                             "is not bitwise the plain version")
    (B, S), (U, cap, nsub), K = sel.shape, codes.shape, lut.shape[2]
    n_read = torch.unique(sel).numel()
    b_ms, b_by = bound(4 * B * nsub * K + n_read * cap * nsub + 4 * B * S
                       + 4 * B * S * cap, B * S * cap * nsub)
    by["adc_score_blocks"]["shapes"].append(
        f"router host codes {(U, cap, nsub)} sel {(B, S)}: ms "
        f"{graph_ms(lambda: adc_score_blocks(lut, codes, sel)):.4f} plain "
        f"{cuda_ms(lambda: adc_score_blocks_ref(lut, codes, sel), 3):.4f} "
        f"bound {b_ms:.4f} ({b_by})")
    x = merge_in
    v, i = topk(x, k)
    rv, ri = topk_ref(x, k)
    if not (torch.equal(i, ri) and torch.equal(v.view(torch.int32),
                                               rv.view(torch.int32))):
        raise AssertionError("topk on the distributed merge rows is not "
                             "bitwise the plain version")
    B, D = x.shape
    b_ms, b_by = bound(4 * B * D + 12 * B * k, B * D)
    by["topk"]["shapes"].append(
        f"distributed merge ({B}, {D}) k {k}: ms "
        f"{graph_ms(lambda: topk(x, k)):.4f} plain "
        f"{cuda_ms(lambda: topk_ref(x, k), 3):.4f} library "
        f"{graph_ms(lambda: torch.topk(x, k), 5):.4f} bound {b_ms:.4f} "
        f"({b_by})")
    for name, n in (("cluster_score", 2), ("adc_score_blocks", 1),
                    ("topk", 1)):
        for note in by[name]["shapes"][-n:]:
            print(f"  {name}: {note}", flush=True)


def parity(name, make_engine, qs, dev, atol):
    """The first PARITY_QUERIES queries served by make_engine(dev) and by
    make_engine("cpu") (plain versions): ids equal at isolated ranks,
    scores within rtol 1e-5 and `atol`."""
    q3 = queries(qs, 0, PARITY_QUERIES)
    with make_engine(dev) as eng:
        g_ids, g_sc = (t.cpu().numpy() for t in eng.retrieve(*q3))
    with make_engine("cpu") as eng:
        c_ids, c_sc = (t.numpy() for t in eng.retrieve(*q3))
    ok = isolated_ranks(c_sc, PARITY_GAP)
    bad = int((g_ids[ok] != c_ids[ok]).sum())
    close = np.allclose(g_sc, c_sc, rtol=1e-5, atol=atol)
    print(f"  {name}: ranks compared {int(ok.sum())} of {ok.size}; id "
          f"mismatches {bad}; scores allclose(rtol 1e-5, atol {atol}) "
          f"{close}; max |score diff| {np.abs(g_sc - c_sc).max():.3g}")
    if bad or not close:
        raise AssertionError(f"{name}: card and CPU disagree")


def dir_engine(path):
    from repro_torch.index import IndexReader
    return lambda d: IndexReader.open(path).engine(
        max_batch=MAX_BATCH, prefetch=False, device=d)


def device_engine(cfg, index):
    from repro_torch.engine import RetrievalEngine
    return lambda d: RetrievalEngine(cfg, index.to(d), max_batch=MAX_BATCH,
                                     device=d)


def disk_engine(cfg, index, blocks):
    from repro_torch.engine import DiskStore, RetrievalEngine
    return lambda d: RetrievalEngine(
        cfg, index.to(d), store=DiskStore(blocks, index.cluster_docs),
        max_batch=MAX_BATCH, prefetch=False, device=d)


def load_index_engine(path):
    from repro_torch.engine import RetrievalEngine
    from repro_torch.index import IndexReader
    return lambda d: RetrievalEngine(
        *IndexReader.open(path).load_index(device=d), max_batch=MAX_BATCH,
        device=d)


# the kernels each serving path must launch
PATH_KERNELS = {
    "memory": ("cluster_score", "lstm_sequence", "topk", "bin_overlap"),
    "pq": ("adc_tables", "adc_score_blocks", "lstm_sequence", "topk",
           "bin_overlap"),
    "v2": ("adc_tables", "adc_score_blocks", "lstm_sequence", "topk",
           "bin_overlap"),
    "v1": ("cluster_score", "lstm_sequence", "topk", "bin_overlap"),
    "disk": ("cluster_score", "lstm_sequence", "topk", "bin_overlap"),
    "v1_pq": ("adc_tables", "adc_score_blocks", "lstm_sequence", "topk",
              "bin_overlap"),
    "recsys": ("embedding_bag", "topk", "bin_overlap", "lstm_sequence"),
    # the neighbor graph's topk and one served v2 batch
    "offline": ("adc_tables", "adc_score_blocks", "lstm_sequence", "topk",
                "bin_overlap"),
    "update_v2": ("adc_tables", "adc_score_blocks", "lstm_sequence", "topk",
                  "bin_overlap"),
    # the re-cluster's neighbor graph (topk) and v1 serving
    "update_v1": ("cluster_score", "lstm_sequence", "topk", "bin_overlap"),
    # labels (sparse top-k, Stage I), the train step's forward,
    # calibration, v2 serving beside and after the publish, the recsys
    # step's wide bag, and the build_index CLI's v1 directory served
    # ("dot" tail)
    "train": ("adc_tables", "adc_score_blocks", "lstm_sequence", "topk",
              "bin_overlap", "embedding_bag", "cluster_score"),
    # the ranks' timed steps (sparse, Stage I/II, the owned blocks, the
    # merges) and the guide top-k
    "distributed": ("cluster_score", "lstm_sequence", "topk", "bin_overlap"),
    # v2 at 4 hosts R 2 (ADC hosts) and one v1 batch ("dot" hosts)
    "router": ("adc_tables", "adc_score_blocks", "cluster_score",
               "lstm_sequence", "topk", "bin_overlap"),
}


def check_path_launches(paths):
    """Every kernel of each path that has run launched in its run."""
    missing = {p: [k for k in PATH_KERNELS[p] if paths[p][k] <= 0]
               for p in paths}
    if any(missing.values()):
        raise AssertionError(f"kernels of a main path never launched: "
                             f"{missing}; launches {paths}")


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
    t_start = time.perf_counter()

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
            for ln in ptxas_summary(log["ptxas"]):
                print(f"  {ln}")

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
            index, pq, corpus, qs = build_state(cfg, dev, N_QUERIES)
            print(f"  device memory: {torch.cuda.memory_allocated() / 1e9:.2f}"
                  f" GB allocated, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            # the offline phase's np.memmap source, staged while the
            # corpus is in RAM
            t0 = time.perf_counter()
            emb_path = os.path.join(tmp, "embeddings.f32")
            corpus.embeddings.tofile(emb_path)
            doc_terms, doc_weights = corpus.doc_terms, corpus.doc_weights
            selector = index.selector
            print(f"  staged the embeddings to a file: "
                  f"{os.path.getsize(emb_path)} bytes in "
                  f"{time.perf_counter() - t0:.2f} s")
        with phase("index directories (write_index v2, v1 float32 with "
                   "pq/) and the DiskClusterStore file"):
            dirs, blocks = write_dirs(cfg, index, pq, corpus, tmp)
        paths = {}
        # device stores: the ADC tail is bitwise the plain version's, so
        # rtol alone for PQStore; dot products are summed in another order
        # on the card, so atol 1e-6 for InMemoryStore
        index.embeddings = torch.from_numpy(corpus.embeddings).to(dev)
        with phase(f"device InMemoryStore serving: {N_QUERIES} queries + 1 "
                   f"profiled batch + parity on {PARITY_QUERIES}"):
            paths["memory"], eng = serve_device("memory", cfg, index, qs,
                                                N_QUERIES, dev)
            cs_notes = [memory_store_case(eng, qs)]
            eng.close()
            del eng
            parity("memory", device_engine(cfg, index), qs, dev, 1e-6)
            dist_job = stage_distributed(cfg, index, emb_path, qs, tmp, dev)
        index.embeddings, index.quantizer = None, pq
        del corpus
        with phase(f"device PQStore serving: {N_QUERIES} queries + 1 "
                   f"profiled batch + parity on {PARITY_QUERIES}"):
            paths["pq"], eng = serve_device("pq", cfg, index, qs, N_QUERIES,
                                            dev)
            tail = tail_inputs(eng, qs, dev)
            eng.close()
            del eng
            parity("pq", device_engine(cfg, index), qs, dev, 0.0)
        with phase(f"rnn and mlp selectors: one batch of {MAX_BATCH}, card "
                   f"vs CPU on {PARITY_QUERIES}"):
            selector_batches(cfg, index, qs, dev)
            index._stores.clear()
        # the DiskStore's "dot" tail scores float blocks summed in another
        # order on the card, so atol 1e-6 as for v1
        with phase(f"DiskStore serving: {N_QUERIES} queries + 1 profiled "
                   f"batch + parity on {PARITY_QUERIES}"):
            paths["disk"], eng = serve_disk(cfg, index, blocks, qs,
                                            N_QUERIES, dev)
            eng.close()
            del eng
            parity("disk", disk_engine(cfg, index, blocks), qs, dev, 1e-6)
            os.remove(blocks.path)
            del blocks
        del index, pq
        with phase(f"v2 serving: {N_QUERIES} queries + 1 profiled batch"):
            paths["v2"], eng_v2 = serve_path("v2", dirs["v2"], qs, N_QUERIES,
                                             dev)
            eng_v2.close()
        with phase(f"v1 serving: {N_QUERIES} queries + 1 profiled batch"):
            paths["v1"], eng_v1 = serve_path("v1", dirs["v1"], qs, N_QUERIES,
                                             dev)
        with phase("reloads on the v1 engine"):
            reload_phase(eng_v1, dirs["v1"], qs, dev)
            eng_v1.close()
        # the v1 directory's PQ serves by the ADC kernels, bitwise the
        # plain versions', so rtol alone
        with phase(f"v1 with its quantizer: {N_QUERIES} queries + 1 "
                   f"profiled batch + parity on {PARITY_QUERIES}"):
            paths["v1_pq"], eng = serve_v1_pq(dirs["v1"], qs, N_QUERIES, dev)
            eng.close()
            del eng
            parity("v1_pq", load_index_engine(dirs["v1"]), qs, dev, 0.0)
        with phase(f"recsys: wide_deep {RECSYS_SIZE}"):
            paths["recsys"], eb = recsys_phase(dev)
            guide = (eb["guide_row"][0].clone(), eb["k_guide"],
                     RECSYS_CLUSTERS, RECSYS_CAP)
        launches = {k: sum(p[k] for p in paths.values())
                    for k in paths["v2"]}
        print(f"  launches over the {len(paths)} paths: {launches}")
        check_path_launches(paths)
        with phase("kernels vs plain versions on main-path inputs"):
            v2_in = main_path_inputs(eng_v2, qs, dev)
            v1_in = main_path_inputs(eng_v1, qs, dev)
            codebooks = torch.from_numpy(eng_v2.store.codebooks).to(dev)
            # neighbor_graph's top-k input, made as it makes it
            C = eng_v2.index.centroids
            nb_sims = C @ C.T - 2e9 * torch.eye(C.shape[0], device=dev)
            rows = check_kernels(dev, launches, v2_in, v1_in, tail,
                                 codebooks, eng_v2.index.selector, eb,
                                 nb_sims, cs_notes)
            del v1_in, v2_in, tail, eb, nb_sims
        with phase("embedding_bag: two threads' error words, the word's "
                   "fill"):
            bag_threads(dev)
        # before the offline phase, which removes the staged embeddings
        with phase(f"distributed: make_serve_step on {DIST_RANKS} gloo "
                   f"ranks on the card, {DIST_QUERIES} queries"):
            paths["distributed"], merge_in, dist_cs = distributed_phase(
                dist_job, guide, dev)
        # the update paths, each driven with the counts zeroed just before
        # it and read just after; their launches join the kernel table's
        with phase(f"offline build from an np.memmap (shards of "
                   f"{OFFLINE_SHARD_DOCS}), a v2 write training its PQ, "
                   f"one batch"):
            paths["offline"] = offline_phase(cfg, emb_path, doc_terms,
                                             doc_weights, selector, qs, tmp,
                                             dev)
        with phase(f"v2 update through the port's CLI ({UPDATE_UPSERTS} "
                   f"upserts, {UPDATE_DELETES} deletes), card vs CPU"):
            paths["update_v2"] = update_v2_phase(dirs["v2"], tmp, dev)
        with phase("v1 re-clustering delta under serving, reload, "
                   "compaction, reload"):
            paths["update_v1"] = update_v1_phase(dirs["v1"], qs, dev)
        with phase(f"train: labels ({TRAIN_QUERIES} + {HOLDOUT_QUERIES} "
                   f"queries, chunks of {TRAIN_CHUNK}), train_selector "
                   f"--publish beside serving, --resume, build_index, "
                   f"recsys make_train_step; the gates"):
            paths["train"], t_in = train_phase(dirs["v2"], qs, tmp, dev)
        with phase("kernels vs plain versions on the train path's shapes"):
            check_train_kernels(rows, dev, t_in)
            del t_in
        with phase("router: the serve CLI (4 hosts R 2, a host killed, "
                   "live endpoint), v2/v1 against the engine, degraded, "
                   "a rolling reload"):
            paths["router"], host_args = router_phase(dirs, qs, tmp, dev)
        with phase("kernels vs plain versions on the router's and the "
                   "distributed step's shapes"):
            check_router_kernels(rows, dev, host_args, merge_in,
                                 cfg.k_sparse, dist_cs)
            del host_args, merge_in
        launches = {k: sum(p[k] for p in paths.values())
                    for k in paths["v2"]}
        print(f"  launches over the {len(paths)} paths: {launches}")
        check_path_launches(paths)
        for r in rows:
            r["launches"] = launches[r["name"]]
        # v2's ADC scores are bitwise the plain version's, so rtol alone;
        # v1's dot products are summed in another order on the card
        for name, atol in (("v2", 0.0), ("v1", 1e-6)):
            with phase(f"parity {name}: {PARITY_QUERIES} queries, card vs "
                       f"CPU"):
                parity(name, dir_engine(dirs[name]), qs, dev, atol)
    print(f"chip_smoke total {time.perf_counter() - t_start:.2f} s")
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
