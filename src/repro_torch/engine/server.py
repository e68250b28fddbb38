"""RetrievalEngine: the serving front-end over a host (disk) store.

  * bucketed batching — query batches are padded to power-of-two sizes
    (capped at `max_batch`); oversize batches are chunked. A batch that
    is the first of its (stage, bucket) is flagged `compiled`, as in the
    JAX engine where it paid a jit compile, so steady-state statistics
    leave out the same batches.
  * LRU block cache — fetched code blocks land in a byte-budgeted
    BlockCache keyed by cluster id, sized in float32-block equivalents
    (`cache_capacity * cap * dim * 4` bytes).
  * async prefetch — a background thread pulls Stage-I candidate blocks
    into the cache while the Stage-II selection runs.
  * ADC serving — raw PQ codes flow disk -> cache -> device and are
    scored against per-query lookup tables inside the fused tail; the
    LUT is built right after Stage I. `lut_build_ms` / `adc_ms` report
    steady-state time.

Usage:
    engine = RetrievalEngine(cfg, index, store=ShardedPQStore(...))
    ids, scores = engine.retrieve(q_dense, q_terms, q_weights)
    engine.stats()   # latency percentiles, cache hit rate, I/O counters
    engine.close()

`device=None` serves on the CUDA card (repro_torch.device); the index is
moved there. reload_index / reload_selector and explain records wait for
a later slice.
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

from repro_torch.device import resolve_device, synchronize
from repro_torch.engine import pipeline as pipe_lib
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


class RetrievalEngine:
    """Serving layer over a code-backed host ClusterStore."""

    _PF_CHUNK = 8            # blocks per prefetch fetch (lock granularity)

    def __init__(self, cfg, index, store, *, max_batch=256,
                 cache_capacity=512, prefetch=True, trace_sample_rate=0.0,
                 device=None):
        if not (getattr(store, "is_host", False)
                and getattr(store, "is_coded", False)):
            raise NotImplementedError(
                "this slice serves code-backed host stores (ShardedPQStore); "
                "float-block and device stores come later")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.index = index.to(self.device)    # no copy where it already is
        self.store = store
        self.use_adc = True
        self.max_batch = max(1, max_batch)
        self.k = cfg.k_final
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(sample_rate=trace_sample_rate)
        self._adc_ms = self.metrics.counter("serve.adc_ms")
        self._lut_build_ms = self.metrics.counter("serve.lut_build_ms")
        self._prefetch_enabled = bool(prefetch)
        self._lock = threading.RLock()
        self.serve_stats = ServeStats(self.metrics)
        self.cache = BlockCache(int(cache_capacity)
                                * store.cap * store.dim * 4) \
            if cache_capacity else None
        # prefetch candidates a bit past the selection budget: Stage II
        # mostly keeps high-ranked Stage-I candidates
        self.prefetch_depth = min(cfg.n_candidates_total,
                                  cfg.max_selected + cfg.max_selected // 2)
        self._fns: Dict[Any, Any] = {}          # (kind, bucket) -> fn
        self._pf_q = None
        self._pf_thread = None
        if self._prefetch_enabled and self.cache is not None:
            self._pf_q = queue.Queue(maxsize=64)
            self._pf_thread = threading.Thread(target=self._prefetch_worker,
                                               daemon=True)
            self._pf_thread.start()

    @property
    def adc_ms(self):
        return float(self._adc_ms.value)

    @property
    def lut_build_ms(self):
        return float(self._lut_build_ms.value)

    # -- lifecycle ----------------------------------------------------------

    def close(self):
        if self._pf_q is not None:
            self._pf_q.put(None)
            # the queue is bounded and fetches are chunked, so the drain is
            # finite — and stats() after close() must be final
            self._pf_thread.join()
            self._pf_q = None
            self._pf_thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- prefetch -----------------------------------------------------------

    def _fill(self, cids):
        return np.asarray(self.store.fetch_code_blocks(np.asarray(cids))[0])

    def _prefetch_worker(self):
        while True:
            cids = self._pf_q.get()
            if cids is None:
                return
            try:
                # record=False: prefetch probes must not skew the serving
                # hit rate; small chunks keep the serving thread from
                # waiting behind the whole candidate set
                for i in range(0, len(cids), self._PF_CHUNK):
                    self.cache.get_or_fetch_many(
                        cids[i:i + self._PF_CHUNK], self._fill, record=False)
            except Exception:       # prefetch is best-effort; never kill serving
                _log.exception("prefetch of %d blocks failed", len(cids))
                self.serve_stats.record_prefetch_error()

    def _enqueue_prefetch(self, cand):
        """cand: (B, n_candidates) host array, stage-1 ordered."""
        q = self._pf_q
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

    def _fused_fn(self, bucket, ubucket):
        return self._fn("adc", (bucket, ubucket),
                        lambda: pipe_lib.build_fused_scorer(
                            self.cfg, self.index, k=self.k))

    # -- serving ------------------------------------------------------------

    def retrieve(self, q_dense, q_terms, q_weights):
        """Serve a query batch of any size. Returns (ids, scores) on the
        engine's device, with the caller's batch dimension preserved."""
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
        with self._lock, torch.inference_mode():
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
            ids, scores = self._serve_host(bucket, qd, qt, qw, tr, n=n)
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
        dev = self.device
        with tr.span("stage1"):
            sid, ss, cand, feats = self._stage1_fn(bucket)(qd, qt, qw)
            cand_np = cand.cpu().numpy()    # device sync for Stage I
            # start pulling candidate blocks while Stage II runs
            self._enqueue_prefetch(cand_np)
        # the LUT depends only on the queries: build it while the
        # prefetcher pulls candidate code blocks
        with tr.span("lut_build"):
            t0 = time.perf_counter()
            lut = self._lut_fn(bucket)(qd)
            synchronize(dev)
            if not self._built_fn:   # steady-state only
                self._lut_build_ms.inc((time.perf_counter() - t0) * 1e3)
        with tr.span("stage2_select"):
            sel_ids, sel_mask, _ = self._stage2_fn(bucket)(cand, feats)
            sel_np = sel_ids.cpu().numpy()  # device sync for Stage II
            mask_np = sel_mask.cpu().numpy()
        with tr.span("fuse"):               # host glue: dedup + positions
            uniq, pos = pipe_lib.dedup_selected(sel_np, mask_np)
        if bool(mask_np.any()):
            with tr.span("cache_fetch", n_blocks=len(uniq)) as sp:
                blocks = pipe_lib.fetch_unique_code_blocks(
                    self.store, uniq, self.cache, trace=tr)
                sp.annotate(bytes=int(blocks.nbytes))
        else:       # nothing selected: zero placeholder, no I/O
            blocks = np.zeros((1, self.store.cap, self.store.nsub), np.uint8)
        with tr.span("fused_score_topk"):
            # the JAX engine pads the unique-block axis to a power of two
            # to bound its compilations; eager PyTorch needs no padding,
            # but the power of two stays part of the stage key, so that a
            # batch is flagged `compiled` exactly when the JAX engine's is
            ub = self._pow2(blocks.shape[0])
            fn = self._fused_fn(bucket, ub)
            t0 = time.perf_counter()
            with tr.span("h2d", bytes=int(blocks.nbytes)):
                blocks_d = torch.from_numpy(blocks).to(dev)
                pos_d = torch.from_numpy(pos).to(dev)
            ids, scores = fn(lut, sid, ss, sel_ids, sel_mask, blocks_d, pos_d)
            synchronize(dev)
            if not self._built_fn:   # steady-state only
                self._adc_ms.inc((time.perf_counter() - t0) * 1e3)
        return ids, scores

    # -- introspection ------------------------------------------------------

    def _sync_gauges(self):
        """Mirror cache/IOStats counters into registry gauges."""
        reg = self.metrics
        if self.cache is not None:
            for k, v in self.cache.stats().items():
                if isinstance(v, (int, float)):
                    reg.gauge(f"cache.{k}").set(v)
        io = self.store.stats
        reg.gauge("io.n_ops").set(io.n_ops)
        reg.gauge("io.bytes").set(io.bytes)
        reg.gauge("io.wall_ms").set(round(io.wall_ms, 2))
        reg.gauge("io.model_ms").set(round(io.model_ms(), 2))
        reg.gauge("serve.decode_ms").set(round(self.store.decode_ms, 2))

    def stats(self):
        self._sync_gauges()
        ss = self.serve_stats
        io = self.store.stats
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
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        out["io"] = {"n_ops": io.n_ops, "bytes": io.bytes,
                     "wall_ms": round(io.wall_ms, 2),
                     "model_ms": round(io.model_ms(), 2)}
        out["use_adc"] = self.use_adc
        out["decode_ms"] = round(self.store.decode_ms, 2)
        out["adc_ms"] = round(self.adc_ms, 2)
        out["lut_build_ms"] = round(self.lut_build_ms, 2)
        return out
