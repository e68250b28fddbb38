"""RetrievalEngine: the serving front-end over a ClusterStore.

  * bucketed batching — query batches are padded to power-of-two sizes
    (capped at `max_batch`); oversize batches are chunked. A batch that
    is the first of its (stage, bucket) is flagged `compiled`, as in the
    JAX engine where it paid a jit compile, so steady-state statistics
    leave out the same batches.
  * LRU block cache — fetched blocks land in a byte-budgeted BlockCache
    keyed by cluster id, sized in float32-block equivalents
    (`cache_capacity * cap * dim * 4` bytes): a float store caches
    `cache_capacity` blocks, a code-backed store 4*dim/nsub times more.
  * async prefetch — a background thread pulls Stage-I candidate blocks
    into the cache while the Stage-II selection runs.
  * device stores (InMemoryStore, PQStore; the default, `store=None`,
    is `store_for_index(index)`) serve the whole batch on the device
    through `pipeline.retrieve` (span `device_pipeline`), with no block
    cache, prefetch thread or explain records, as in the JAX engine.
  * fused tail (host stores) — score -> fuse -> top-k over the batch's
    unique blocks on the device. Code-backed stores (v2) serve by ADC
    (`use_adc`, auto-on):
    raw PQ codes flow disk -> cache -> device and are scored against
    per-query lookup tables built right after Stage I (kernels adc_tables,
    adc_score_blocks). Float stores (v1) serve the "dot" tail: float
    blocks are scored by the kernel cluster_score.

Zero-downtime swaps: `reload_index()` hops to a newer committed index
generation between batches (arrays and store rebuilt from the reader,
stage functions and the block cache invalidated, the prefetch worker
quiesced across the swap); `reload_selector()` swaps only the Stage-II
selector and its calibrated theta/budget, keeping the store, the cache
and the Stage-I functions. Sampled explain records
(repro_torch.obs.ExplainLogger) say why each query retrieved what it did.

Usage:
    engine = IndexReader.open(index_dir).engine()        # reader-backed
    engine = RetrievalEngine(cfg, index)                 # device store
    engine = RetrievalEngine(cfg, index, store=ShardedPQStore(...))
    ids, scores = engine.retrieve(q_dense, q_terms, q_weights)
    engine.stats()   # latency percentiles, cache hit rate, I/O counters
    engine.reload_index()
    engine.close()

`device=None` serves on the CUDA card (repro_torch.device); the index is
moved there, and a default device store is built there from it.
"""

import collections
import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.convert import selector_from_numpy
from repro_torch.core.fusion import FUSION_METHODS
from repro_torch.device import resolve_device, synchronize
from repro_torch.engine import pipeline as pipe_lib
from repro_torch.engine import stores as stores_lib
from repro_torch.engine.cache import BlockCache
from repro_torch.obs import NOOP_TRACE, MetricsRegistry, Tracer

_log = logging.getLogger(__name__)


def bucket_size(n, max_batch):
    """Smallest power of two >= n, capped at max_batch."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


def _host(x):
    """A numpy view of a host array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pad_rows(x, n_pad):
    """Pad axis 0 by repeating the last row (keeps ids/terms in range)."""
    if n_pad == 0:
        return x
    return np.concatenate([x, np.repeat(x[-1:], n_pad, axis=0)])


def build_explain_records(cfg, *, qid_base, generation, n, cand, probs,
                          sel_ids, sel_mask, final_ids, sparse_ids,
                          doc_cluster):
    """Explain records for one served batch (the JAX engine's schema).

    Array arguments are batch-major, numpy or tensors on any device; only
    the first `n` rows (real queries, not bucket padding) produce
    records. `doc_cluster` maps doc id -> cluster id and decides the
    dense side of the fusion contribution split."""
    cand = _host(cand)[:n]
    probs = _host(probs)[:n]
    sel_np = _host(sel_ids)[:n]
    mask_np = _host(sel_mask)[:n].astype(bool)
    final = _host(final_ids)[:n]
    sid = _host(sparse_ids)[:n]
    dc = _host(doc_cluster)
    n_seed = int(cfg.n_candidates)
    theta = float(cfg.theta)
    records = []
    for i in range(n):
        p = probs[i]
        selected = [int(x) for x in sel_np[i][mask_np[i]]]
        sel_set = set(selected)
        over = int((p >= theta).sum())
        sparse_set = {int(d) for d in sid[i] if int(d) >= 0}
        contrib = {"sparse_only": 0, "dense_only": 0, "both": 0}
        for d in (int(x) for x in final[i] if int(x) >= 0):
            in_sparse = d in sparse_set
            in_dense = d < len(dc) and int(dc[d]) in sel_set
            if in_sparse and in_dense:
                contrib["both"] += 1
            elif in_sparse:
                contrib["sparse_only"] += 1
            elif in_dense:
                contrib["dense_only"] += 1
        records.append({
            "qid": int(qid_base + i),
            "generation": None if generation is None else int(generation),
            "theta": round(theta, 6),
            "budget": int(cfg.max_selected),
            "fusion": cfg.fusion,
            "expand_depth": int(cfg.expand_depth),
            "n_seed": n_seed,
            "cand": [int(x) for x in cand[i]],
            "provenance": ["seed" if j < n_seed else "expand"
                           for j in range(cand.shape[1])],
            "probs": [round(float(x), 4) for x in p],
            "selected": selected,
            "n_over_theta": over,
            "skipped_over_theta": max(0, over - len(selected)),
            "fusion_contrib": contrib,
        })
    return records


@dataclasses.dataclass
class BatchRecord:
    size: int          # real queries in the batch (before padding)
    bucket: int        # padded bucket it ran in
    compiled: bool     # first batch of a (stage, bucket)
    ms: float


class ServeStats:
    """Serving counters, registry-backed and bounded (the JAX engine's
    ServeStats): cumulative counts are registry counters; per-batch
    records land in a ring of `window` batches plus the registry's
    `serve.batch_ms` histogram."""

    WINDOW = 8192

    def __init__(self, registry=None, window=WINDOW):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.window = int(window)
        reg = self.registry
        self._queries = reg.counter("serve.queries")
        self._batches = reg.counter("serve.batches")
        self._compile_batches = reg.counter("serve.compile_batches")
        self._steady_queries = reg.counter("serve.steady_queries")
        self._steady_ms = reg.counter("serve.steady_ms")
        self._batch_ms_hist = reg.histogram("serve.batch_ms",
                                            ring=self.window)
        self._prefetch_enqueued = reg.counter("serve.prefetch_enqueued")
        self._prefetch_errors = reg.counter("serve.prefetch_errors")
        self._reloads = reg.counter("serve.reloads")
        self._selector_reloads = reg.counter("serve.selector_reloads")
        self.batches = collections.deque(maxlen=self.window)
        self._compiled_bucket_set = set()

    @property
    def n_queries(self):
        return int(self._queries.value)

    @property
    def n_batches(self):
        return int(self._batches.value)

    @property
    def n_compile_batches(self):
        return int(self._compile_batches.value)

    @property
    def prefetch_enqueued(self):
        return int(self._prefetch_enqueued.value)

    @property
    def prefetch_errors(self):
        return int(self._prefetch_errors.value)

    @property
    def reloads(self):
        return int(self._reloads.value)

    @property
    def selector_reloads(self):
        return int(self._selector_reloads.value)

    def record(self, size, bucket, compiled, ms):
        self._queries.inc(size)
        self._batches.inc()
        if compiled:
            self._compile_batches.inc()
            self._compiled_bucket_set.add(bucket)
        else:
            self._steady_queries.inc(size)
            self._steady_ms.inc(ms)
            self._batch_ms_hist.observe(ms)
        self.batches.append(BatchRecord(size, bucket, compiled, ms))

    def record_prefetch(self, n):
        self._prefetch_enqueued.inc(n)

    def record_prefetch_error(self):
        self._prefetch_errors.inc()

    def record_reload(self):
        self._reloads.inc()

    def record_selector_reload(self):
        self._selector_reloads.inc()

    @property
    def compiled_buckets(self):
        return sorted(self._compiled_bucket_set)

    def _steady(self):
        return [b for b in self.batches if not b.compiled]

    def steady_qps(self):
        t = float(self._steady_ms.value)
        return float(self._steady_queries.value) / (t / 1e3) if t else 0.0

    def latency_percentiles(self):
        """Steady-state (first batches of a bucket excluded) batch latency."""
        steady = [b.ms for b in self._steady()]
        if not steady:
            return {}
        lat = np.asarray(steady)
        return {"p50_ms": round(float(np.percentile(lat, 50)), 3),
                "p99_ms": round(float(np.percentile(lat, 99)), 3),
                "mean_ms": round(float(lat.mean()), 3)}

    def reset(self):
        """Zero every counter and drop the batch window."""
        for c in (self._queries, self._batches, self._compile_batches,
                  self._steady_queries, self._steady_ms,
                  self._prefetch_enqueued, self._prefetch_errors,
                  self._reloads, self._selector_reloads):
            c.reset()
        self._batch_ms_hist.reset()
        self.batches.clear()
        self._compiled_bucket_set.clear()


class RetrievalEngine:
    """Serving layer over a ClusterStore: a device store (InMemoryStore,
    PQStore), one on-disk block file (DiskStore, "dot" tail), v1 float
    block shards (ShardedDiskStore, "dot" tail) or v2 PQ code shards
    (ShardedPQStore, ADC tail)."""

    _PF_CHUNK = 8            # blocks per prefetch fetch (lock granularity)

    def __init__(self, cfg, index, store=None, *, max_batch=256,
                 cache_capacity=512, prefetch=True, prefetch_depth=None,
                 k=None, reader=None, use_adc=None, metrics=None,
                 tracer=None, trace_sample_rate=None, fusion=None,
                 explain=None, device=None):
        if fusion is not None and fusion not in FUSION_METHODS:
            raise ValueError(f"fusion must be one of {FUSION_METHODS}, "
                             f"got {fusion!r}")
        # per-engine fusion override: wins over the manifest config and is
        # re-applied across index and selector reloads
        self._fusion_override = fusion
        self.device = resolve_device(device)
        self.cfg = self._apply_cfg_overrides(cfg)
        self.index = index.to(self.device)    # no copy where it already is
        self.store = store if store is not None \
            else stores_lib.store_for_index(self.index)
        self.is_host = bool(getattr(self.store, "is_host", False))
        self.max_batch = max(1, max_batch)
        self.k = k or self.cfg.k_final
        self.reader = reader            # IndexReader backing the reloads
        # None = auto (ADC exactly when the store is code-backed); True
        # demands a code-backed store; False serves decoded float blocks
        self._explicit_use_adc = use_adc
        self.use_adc = self._resolve_use_adc(self.store)
        # the registry backs stats(); the tracer records per-batch spans
        # when its sample rate is above 0 (a caller's, shared, or a new one)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if tracer is None:
            tracer = Tracer(sample_rate=trace_sample_rate or 0.0)
        elif trace_sample_rate is not None:
            tracer.sample_rate = float(trace_sample_rate)
        self.tracer = tracer
        # sampled explain telemetry (repro_torch.obs.ExplainLogger); None
        # costs one attribute check per batch
        self.explain = explain
        self._adc_ms = self.metrics.counter("serve.adc_ms")
        self._lut_build_ms = self.metrics.counter("serve.lut_build_ms")
        self._prefetch_enabled = bool(prefetch)
        self._swap_lock = threading.RLock()   # serving vs the reloads
        self._pf_drop = False           # quiesce flag across index swaps
        self.serve_stats = ServeStats(self.metrics)
        self._cache_capacity = cache_capacity
        self.cache = self._make_cache(self.store) \
            if (self.is_host and cache_capacity) else None
        # prefetch candidates a bit past the selection budget: Stage II
        # mostly keeps high-ranked Stage-I candidates. An explicit depth
        # is pinned; the default follows cfg.max_selected across reloads.
        self._explicit_prefetch_depth = prefetch_depth
        self.prefetch_depth = prefetch_depth if prefetch_depth is not None \
            else self._default_prefetch_depth(self.cfg)
        self._fns: Dict[Any, Any] = {}          # (kind, bucket) -> fn
        self._pf_q = None
        self._pf_thread = None
        self._start_prefetch()

    @property
    def adc_ms(self):
        return float(self._adc_ms.value)

    @property
    def lut_build_ms(self):
        return float(self._lut_build_ms.value)

    # -- lifecycle ----------------------------------------------------------

    def _resolve_use_adc(self, store):
        """ADC serving of the host tail: None = auto (on exactly when a
        host store is code-backed); True demands a code-backed store. A
        device store scores through its own kernels either way."""
        coded = bool(getattr(store, "is_coded", False))
        if self._explicit_use_adc is None:
            return self.is_host and coded
        if self._explicit_use_adc and not coded:
            raise ValueError("use_adc=True needs a code-backed store "
                             "(is_coded); this store serves float blocks")
        return bool(self._explicit_use_adc) and self.is_host

    def _make_cache(self, store):
        """Byte budget in float32-block equivalents of the store's geometry."""
        return BlockCache(int(self._cache_capacity) * int(store.cap)
                          * int(store.dim) * 4)

    def _apply_cfg_overrides(self, cfg):
        if self._fusion_override is not None \
                and cfg.fusion != self._fusion_override:
            cfg = dataclasses.replace(cfg, fusion=self._fusion_override)
        return cfg

    @staticmethod
    def _default_prefetch_depth(cfg):
        return min(cfg.n_candidates_total,
                   cfg.max_selected + cfg.max_selected // 2)

    def _refresh_prefetch_depth(self, cfg):
        if self._explicit_prefetch_depth is None:
            self.prefetch_depth = self._default_prefetch_depth(cfg)

    def _start_prefetch(self):
        if self._prefetch_enabled and self.cache is not None:
            self._pf_q = queue.Queue(maxsize=64)
            self._pf_thread = threading.Thread(target=self._prefetch_worker,
                                               daemon=True)
            self._pf_thread.start()

    def _stop_prefetch(self):
        if self._pf_q is not None:
            self._pf_q.put(None)
            # the queue is bounded and fetches are chunked, so the drain is
            # finite — and stats() after close() must be final
            self._pf_thread.join()
            self._pf_q = None
            self._pf_thread = None

    def close(self):
        self._stop_prefetch()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- hot swaps ----------------------------------------------------------

    def reload_index(self, reader=None, *, verify="none"):
        """Hot-swap to the index's current committed generation: re-read
        the manifest (`IndexReader.refresh`), rebuild the arrays and the
        store, and replace them between batches. Stage functions and the
        block cache are invalidated; the prefetch worker is stopped across
        the swap, so no block of the old generation can land in the fresh
        cache. In-flight batches finish on the old generation. Cumulative
        counters (I/O, decode, cache hits/misses/evictions/clears, ADC and
        LUT times) are carried over: only `reset_stats()` zeroes them.
        Returns the generation now served."""
        reader = reader if reader is not None else self.reader
        if reader is None:
            raise ValueError("reload_index needs an IndexReader (construct "
                             "the engine via IndexReader.engine, or pass "
                             "reader=)")
        tr = self.tracer.trace("reload_index")
        with tr.span("reload"):
            reader.refresh(verify=verify)
            cfg, index = reader.load_index(device=self.device)
            cfg = self._apply_cfg_overrides(cfg)
            store = reader.open_store(cluster_docs=index.cluster_docs)
            # quiesce prefetch: drop queued candidate ids and wait out any
            # fetch against the old store before the cache is replaced
            restart = self._pf_thread is not None
            self._pf_drop = True
            if restart:
                self._stop_prefetch()
            with self._swap_lock:
                old_store = self.store
                self.cfg, self.index, self.store = cfg, index, store
                self.is_host = True
                self.reader = reader
                self.use_adc = self._resolve_use_adc(store)
                self._refresh_prefetch_depth(cfg)
                self._fns.clear()
                self._carry_store_counters(old_store, store)
                if self.cache is not None:
                    # cluster ids now name the new generation's blocks and
                    # the byte budget may move with the geometry: a new
                    # cache that keeps the lifetime counters
                    old = self.cache
                    new = self._make_cache(store)
                    new.hits, new.misses = old.hits, old.misses
                    new.evictions, new.clears = old.evictions, old.clears + 1
                    self.cache = new
                self.serve_stats.record_reload()
            self._pf_drop = False
            if restart:
                self._start_prefetch()
        tr.finish(generation=reader.generation)
        return reader.generation

    @staticmethod
    def _stage1_cfg(cfg):
        """The config slice the Stage-I functions close over; a selector
        publish that moves it invalidates them too."""
        return (cfg.k_sparse, cfg.bins, cfg.n_candidates, cfg.expand_depth,
                cfg.n_candidates_total, cfg.u_bins)

    @staticmethod
    def _carry_store_counters(old_store, new_store):
        """Carry the cumulative I/O and host-decode counters onto the new
        store, so stats() stays engine-lifetime across reload_index."""
        if new_store is old_store or not old_store.is_host:
            return          # a device store keeps no I/O or decode counters
        old_io, new_io = old_store.stats, new_store.stats
        new_io.add(old_io.n_ops, old_io.bytes, old_io.wall_ms)
        if hasattr(old_store, "decode_ms") and hasattr(new_store,
                                                       "decode_ms"):
            new_store.decode_ms += old_store.decode_ms   # not DiskStore

    def reload_selector(self, reader=None, *, verify="none"):
        """Hot-swap only the Stage-II selector: adopt a newer generation's
        LSTM weights and calibrated theta/budget (a selector publish)
        without touching the store, the block cache, the prefetch worker
        or the Stage-I functions. If the corpus moved too (arrays or block
        shards differ), fall back to `reload_index()`. Returns the
        generation now served."""
        reader = reader if reader is not None else self.reader
        if reader is None:
            raise ValueError("reload_selector needs an IndexReader "
                             "(construct the engine via IndexReader.engine, "
                             "or pass reader=)")
        before = (reader.manifest.get("arrays"),
                  reader.manifest.get("block_shards"))
        reader.refresh(verify=verify)
        after = (reader.manifest.get("arrays"),
                 reader.manifest.get("block_shards"))
        if before != after:
            return self.reload_index(reader, verify="none")
        tr = self.tracer.trace("reload_selector")
        with tr.span("reload"):
            cfg = self._apply_cfg_overrides(reader.config())
            params = reader.lstm_params()
            selector = None if params is None \
                else selector_from_numpy(params, device=self.device)
            with self._swap_lock:
                old_cfg = self.cfg
                self.cfg = cfg
                self.index.selector = selector
                self.reader = reader
                self._refresh_prefetch_depth(cfg)
                # stage2 closes over the selector, theta and the budget;
                # the device pipeline and the fused tails over the whole
                # config. Stage I, the LUT builder (codebooks only) and
                # the cache stay valid.
                stale = {"stage2", "device", "adc", "dot"}
                if self._stage1_cfg(old_cfg) != self._stage1_cfg(cfg):
                    stale.add("stage1")
                for key in [k for k in self._fns if k[0] in stale]:
                    del self._fns[key]
                self.serve_stats.record_selector_reload()
        tr.finish(generation=reader.generation)
        return reader.generation

    # -- prefetch -----------------------------------------------------------

    def _cache_fill_fn(self):
        """What a cache miss fetches: raw code blocks under ADC serving,
        float blocks otherwise (one record type per generation)."""
        store = self.store
        if self.use_adc:
            return lambda c: np.asarray(
                store.fetch_code_blocks(np.asarray(c))[0])
        return lambda c: np.asarray(store.fetch_blocks(np.asarray(c))[0])

    def _prefetch_worker(self):
        while True:
            cids = self._pf_q.get()
            if cids is None:
                return
            if self._pf_drop:
                continue        # a reload is under way: stale candidates
            try:
                # record=False: prefetch probes must not skew the serving
                # hit rate; small chunks keep the serving thread from
                # waiting behind the whole candidate set
                fill = self._cache_fill_fn()
                for i in range(0, len(cids), self._PF_CHUNK):
                    self.cache.get_or_fetch_many(
                        cids[i:i + self._PF_CHUNK], fill, record=False)
            except Exception:       # prefetch is best-effort; never kill serving
                _log.exception("prefetch of %d blocks failed", len(cids))
                self.serve_stats.record_prefetch_error()

    def _enqueue_prefetch(self, cand):
        """cand: (B, n_candidates) host array, stage-1 ordered."""
        q = self._pf_q      # snapshot: reload_index may null the attribute
        if q is None:
            return
        cids = np.unique(cand[:, :self.prefetch_depth])
        cids = [int(c) for c in cids if int(c) not in self.cache]
        if not cids:
            return
        try:
            q.put_nowait(cids)
            self.serve_stats.record_prefetch(len(cids))
        except queue.Full:
            pass

    # -- stages -------------------------------------------------------------

    def _fn(self, kind, bucket, builder):
        key = (kind, bucket)
        fn = self._fns.get(key)
        if fn is None:
            fn = builder()
            self._fns[key] = fn
            self._built_fn = True     # first batch of this (stage, bucket)
        return fn

    def _device_fn(self, bucket):
        """The whole device-store pipeline, fn(qd, qt, qw) -> (ids, scores,
        n_selected). It closes over the config, index and store it was
        built for, not over the engine, so that a closed engine's store
        is freed without waiting for the cycle collector."""
        cfg, index, store, k = self.cfg, self.index, self.store, self.k

        def build():
            def run(qd, qt, qw):
                ids, scores, diag = pipe_lib.retrieve(cfg, index, store, qd,
                                                      qt, qw, k=k)
                return ids, scores, diag["n_selected"]
            return run
        return self._fn("device", bucket, build)

    def _stage1_fn(self, bucket):
        return self._fn("stage1", bucket,
                        lambda: pipe_lib.build_stage1_fn(self.cfg, self.index))

    def _stage2_fn(self, bucket):
        return self._fn("stage2", bucket,
                        lambda: pipe_lib.build_stage2_fn(self.cfg, self.index))

    def _lut_fn(self, bucket):
        return self._fn("lut", bucket,
                        lambda: pipe_lib.build_lut_fn(self.store.codebooks,
                                                      self.store.rotation,
                                                      self.device))

    def _fused_fn(self, kind, bucket, ubucket):
        """One score -> fuse -> top-k tail per (mode, batch bucket,
        unique-block bucket)."""
        return self._fn(kind, (bucket, ubucket),
                        lambda: pipe_lib.build_fused_scorer(
                            self.cfg, self.index, k=self.k, mode=kind))

    # -- serving ------------------------------------------------------------

    def retrieve(self, q_dense, q_terms, q_weights, *, k=None):
        """Serve a query batch of any size. Returns (ids, scores) on the
        engine's device, with the caller's batch dimension preserved.
        `k` may be None or the engine's own k, as in the JAX engine."""
        if k is not None and k != self.k:
            raise ValueError("per-call k would defeat bucketed compilation; "
                             "construct the engine with the serving k")
        q_dense, q_terms, q_weights = (_host(q_dense), _host(q_terms),
                                       _host(q_weights))
        n = int(q_dense.shape[0])
        if n < 1:
            raise ValueError("empty query batch")
        out_ids, out_scores = [], []
        for lo in range(0, n, self.max_batch):
            hi = min(lo + self.max_batch, n)
            ids, scores = self._retrieve_chunk(
                q_dense[lo:hi], q_terms[lo:hi], q_weights[lo:hi])
            out_ids.append(ids)
            out_scores.append(scores)
        if len(out_ids) == 1:
            return out_ids[0], out_scores[0]
        return torch.cat(out_ids), torch.cat(out_scores)

    def _retrieve_chunk(self, q_dense, q_terms, q_weights):
        # one chunk serves on one index generation: the reloads take the
        # same lock, so swaps land between chunks, never inside one
        with self._swap_lock, torch.inference_mode():
            n = int(q_dense.shape[0])
            bucket = bucket_size(n, self.max_batch)
            self._built_fn = False
            tr = self.tracer.trace("batch", size=n, bucket=bucket)
            with tr.span("pad"):
                pad = bucket - n
                dev = self.device
                qd = torch.tensor(_pad_rows(q_dense, pad),
                                  dtype=torch.float32).to(dev)
                qt = torch.tensor(_pad_rows(q_terms, pad),
                                  dtype=torch.int32).to(dev)
                qw = torch.tensor(_pad_rows(q_weights, pad),
                                  dtype=torch.float32).to(dev)
                synchronize(dev)
            # batch_ms starts after the input pad/transfer (`pad` span)
            t0 = time.perf_counter()
            if self.is_host:
                ids, scores = self._serve_host(bucket, qd, qt, qw, tr, n=n)
                synchronize(dev)
            else:
                with tr.span("device_pipeline"):
                    ids, scores, _ = self._device_fn(bucket)(qd, qt, qw)
                    synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
            tr.finish(compiled=self._built_fn, batch_ms=round(ms, 3))
            self.serve_stats.record(n, bucket, self._built_fn, ms)
            return ids[:n], scores[:n]

    @staticmethod
    def _pow2(n):
        b = 1
        while b < n:
            b *= 2
        return b

    def _serve_host(self, bucket, qd, qt, qw, tr=NOOP_TRACE, n=None):
        n = bucket if n is None else n
        dev = self.device
        with tr.span("stage1"):
            sid, ss, cand, feats = self._stage1_fn(bucket)(qd, qt, qw)
            cand_np = cand.cpu().numpy()    # device sync for Stage I
            # start pulling candidate blocks while Stage II runs
            self._enqueue_prefetch(cand_np)
        lut = None
        if self.use_adc:
            # the LUT depends only on the queries: build it while the
            # prefetcher pulls candidate code blocks
            with tr.span("lut_build"):
                t0 = time.perf_counter()
                lut = self._lut_fn(bucket)(qd)
                synchronize(dev)
                if not self._built_fn:   # steady-state only
                    self._lut_build_ms.inc((time.perf_counter() - t0) * 1e3)
        with tr.span("stage2_select"):
            sel_ids, sel_mask, probs = self._stage2_fn(bucket)(cand, feats)
            sel_np = sel_ids.cpu().numpy()  # device sync for Stage II
            mask_np = sel_mask.cpu().numpy()
        with tr.span("fuse"):               # host glue: dedup + positions
            uniq, pos = pipe_lib.dedup_selected(sel_np, mask_np)
        if bool(mask_np.any()):
            with tr.span("cache_fetch", n_blocks=len(uniq)) as sp:
                fetch = pipe_lib.fetch_unique_code_blocks if self.use_adc \
                    else pipe_lib.fetch_unique_blocks
                blocks = fetch(self.store, uniq, self.cache, trace=tr)
                sp.annotate(bytes=int(blocks.nbytes))
        else:       # nothing selected: zero placeholder, no I/O
            blocks = np.zeros(
                (1, self.store.cap,
                 self.store.nsub if self.use_adc else self.store.dim),
                np.uint8 if self.use_adc else np.float32)
        with tr.span("fused_score_topk"):
            # the JAX engine pads the unique-block axis to a power of two
            # to bound its compilations; eager PyTorch needs no padding,
            # but the power of two stays part of the stage key, so that a
            # batch is flagged `compiled` exactly when the JAX engine's is
            kind = "adc" if self.use_adc else "dot"
            fn = self._fused_fn(kind, bucket, self._pow2(blocks.shape[0]))
            t0 = time.perf_counter()
            with tr.span("h2d", bytes=int(blocks.nbytes)):
                blocks_d = torch.from_numpy(blocks).to(dev)
                pos_d = torch.from_numpy(pos).to(dev)
            ids, scores = fn(lut if self.use_adc else qd, sid, ss, sel_ids,
                             sel_mask, blocks_d, pos_d)
            synchronize(dev)
            if self.use_adc and not self._built_fn:   # steady-state only
                self._adc_ms.inc((time.perf_counter() - t0) * 1e3)
        if self.explain is not None and self.explain.sample():
            for rec in build_explain_records(
                    self.cfg,
                    qid_base=self.serve_stats.n_queries,
                    generation=None if self.reader is None
                    else self.reader.generation,
                    n=n, cand=cand_np, probs=probs, sel_ids=sel_np,
                    sel_mask=mask_np, final_ids=ids, sparse_ids=sid,
                    doc_cluster=self.index.doc_cluster):
                self.explain.emit(rec)
        return ids, scores

    # -- introspection ------------------------------------------------------

    def _sync_gauges(self):
        """Mirror cache/IOStats counters into registry gauges (a device
        store has neither)."""
        reg = self.metrics
        if self.cache is not None:
            for k, v in self.cache.stats().items():
                if isinstance(v, (int, float)):
                    reg.gauge(f"cache.{k}").set(v)
        if self.is_host:
            io = self.store.stats
            reg.gauge("io.n_ops").set(io.n_ops)
            reg.gauge("io.bytes").set(io.bytes)
            reg.gauge("io.wall_ms").set(round(io.wall_ms, 2))
            reg.gauge("io.model_ms").set(round(io.model_ms(), 2))
            decode_ms = getattr(self.store, "decode_ms", None)
            if decode_ms is not None:
                reg.gauge("serve.decode_ms").set(round(decode_ms, 2))
        if self.reader is not None:
            reg.gauge("serve.generation").set(self.reader.generation)

    def stats(self):
        """The JAX engine's stats() keys: `io`, `use_adc` and `decode_ms`
        for a host store only, as there."""
        self._sync_gauges()
        ss = self.serve_stats
        out = {"n_queries": ss.n_queries,
               "n_batches": ss.n_batches,
               "n_compile_batches": ss.n_compile_batches,
               "compiled_buckets": ss.compiled_buckets,
               "qps_steady": round(ss.steady_qps(), 1),
               "prefetch_enqueued": ss.prefetch_enqueued,
               "prefetch_errors": ss.prefetch_errors,
               "reloads": ss.reloads,
               "selector_reloads": ss.selector_reloads,
               "fusion": self.cfg.fusion,
               "expand_depth": self.cfg.expand_depth,
               **ss.latency_percentiles()}
        if self.reader is not None:
            out["generation"] = self.reader.generation
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        if self.is_host:
            io = self.store.stats
            out["io"] = {"n_ops": io.n_ops, "bytes": io.bytes,
                         "wall_ms": round(io.wall_ms, 2),
                         "model_ms": round(io.model_ms(), 2)}
            out["use_adc"] = self.use_adc
            decode_ms = getattr(self.store, "decode_ms", None)
            if decode_ms is not None:      # a DiskStore decodes nothing
                out["decode_ms"] = round(decode_ms, 2)
            if self.use_adc:
                out["adc_ms"] = round(self.adc_ms, 2)
                out["lut_build_ms"] = round(self.lut_build_ms, 2)
        return out

    def reset_stats(self):
        """Zero every serving statistic in place (batch windows, counters,
        cache hit/miss/eviction/clear counts, store IOStats and decode
        time) without touching the stage functions, the cached blocks or
        the tracer's traces. The only reset: reloads carry counters."""
        with self._swap_lock:
            self.metrics.reset()
            self.serve_stats.reset()
            if self.cache is not None:
                with self.cache._lock:
                    self.cache.hits = self.cache.misses = 0
                    self.cache.evictions = self.cache.clears = 0
            if self.is_host:
                io = self.store.stats
                io.n_ops, io.bytes, io.wall_ms = 0, 0, 0.0
                if hasattr(self.store, "decode_ms"):
                    self.store.decode_ms = 0.0
