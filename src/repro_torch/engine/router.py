"""Multi-host scatter-gather serving tier: ShardRouter over EngineHosts (a
port of repro.engine.router).

CluSD selects a few clusters per query, so the dense side partitions by
shard: each host needs only the block shards it owns. N hosts run in one
process, each a single-worker executor (its "process") with its own
shard-subset ShardedDiskStore/ShardedPQStore and BlockCache:

  router (ShardRouter)                 host (EngineHost)
  --------------------                 -----------------
  sparse retrieval + Stage I           fetch owned blocks (cache -> disk)
  ADC LUT build (v2)                   score owned selected slots on the
  Stage-II LSTM selection                device (adc_score_blocks for v2,
  scatter selections to owners   --->    cluster_score for v1)
                                 <---  partial top-k (score desc, id asc)
  merge partial top-k (exact tie rule)
  fuse with the sparse side (fuse_topk) + final top-k

Shard placement: block shard s (a contiguous cluster range of the
manifest) is served by hosts [(s + r) % n_hosts for r in
range(replication)]; a slot's owner is found by searchsorted over the
manifest's shard upper bounds.

Merge tie rule: (score desc, doc id asc), np.lexsort((ids, -scores)),
under which -0.0 and +0.0 are equal. Duplicates keep their multiplicity;
each shard group is accepted from exactly one replica, so no slot is
counted twice.

Exactness: a host scores its slots with the kernel the single-host
engine's fused tail scores them with (adc_score_blocks for "adc",
cluster_score for "dot"; both score each slot on its own, so dropping
the other hosts' columns changes no kept score bit), the merged dense
list is the engine's (B, S*cap) slot list as a multiset, and the fuse is
the engine's `fuse_topk` scatter. A doc gets at most two addends there
(Stage I keeps a row's candidates distinct, so its selections and their
docs are too), and two addends onto 0.0 sum alike in either order, so
`fusion="interp"` is bitwise the single-host engine, on the CPU and on
the card. RRF breaks exact-score ties by list position, so rrf parity is
exact except on exact dense-score ties across distinct docs.

Failover: per-host timeout (futures), retry with exponential backoff
(injectable `sleep`), per-host cooldown, replica failover. When every
replica of a shard is down, the batch completes without that shard's
slots (degraded: exactly serving without the shard), counted in
`degraded_requests`, and `stats()` shows `degraded` and
`missing_shards`.

Generation hops roll host by host: `reload_index()` prepares the new
generation on every host beside the old, flips the router's arrays and
stage functions under its lock, then retires the old generation through
each host's queue. Every response of a batch comes from the router's
generation, and a late response of a timed-out host is never merged.

Threads on one card: each host scores on its own CUDA stream and
synchronizes it before its response crosses the HostResponse boundary
as numpy. `device=None` serves on the CUDA card (repro_torch.device).
"""

import collections
import contextlib
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import fusion as fusion_lib
from repro_torch.core.fusion import FUSION_METHODS
from repro_torch.device import resolve_device, synchronize
from repro_torch.engine import pipeline as pipe_lib
from repro_torch.engine.cache import BlockCache
from repro_torch.engine.server import (RetrievalEngine, ServeStats, _host,
                                       _pad_rows, bucket_size,
                                       build_explain_records)
from repro_torch.kernels.adc import adc_score_blocks
from repro_torch.kernels.cluster_score import cluster_score
from repro_torch.obs import NOOP_TRACE, MetricsRegistry, Tracer

# pads and invalid entries of merged partial top-k lists; sorts after
# every real doc id on score ties
MERGE_SENTINEL = np.int64(1) << 62


# ---------------------------------------------------------------------------
# partial top-k merge
# ---------------------------------------------------------------------------

def merge_partial_topk(parts, k):
    """Merge per-host partial top-k lists into one (B, k) list under the
    (score desc, doc id asc) rule of np.lexsort((ids, -scores)).

    parts: list of (ids (B, Ki) int, scores (B, Ki) float) numpy arrays;
    Ki may vary per part. Entries with a non-finite score, an id at or
    above MERGE_SENTINEL, or a negative id are padding. Duplicate ids
    keep their multiplicity.

    Returns (ids (B, k) int64, scores (B, k) float32); with fewer than k
    real entries the tail is (MERGE_SENTINEL, -inf)."""
    if not parts:
        raise ValueError("merge_partial_topk needs at least one part")
    ids = np.concatenate([np.asarray(p[0], np.int64) for p in parts], axis=1)
    ss = np.concatenate(
        [np.asarray(p[1], np.float32) for p in parts], axis=1)
    if ids.shape != ss.shape:
        raise ValueError(f"ids/scores shapes differ: {ids.shape} vs {ss.shape}")
    B, L = ids.shape
    if L < k:
        ids = np.concatenate(
            [ids, np.full((B, k - L), MERGE_SENTINEL, np.int64)], axis=1)
        ss = np.concatenate(
            [ss, np.full((B, k - L), -np.inf, np.float32)], axis=1)
    invalid = ~np.isfinite(ss) | (ids >= MERGE_SENTINEL) | (ids < 0)
    ids = np.where(invalid, MERGE_SENTINEL, ids)
    ss = np.where(invalid, np.float32(-np.inf), ss).astype(np.float32)
    # primary key score desc, secondary id asc (np.lexsort sorts by the
    # last key first)
    order = np.lexsort((ids, -ss), axis=-1)[:, :k]
    return (np.take_along_axis(ids, order, axis=-1),
            np.take_along_axis(ss, order, axis=-1))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

class ShardPlacement:
    """Maps index block shards to replica hosts.

    Default rule: replicas of shard s are [(s + r) % n_hosts for r in
    range(replication)]. An explicit `replicas` dict {shard: [hosts]}
    overrides the rule (a shard mapped to [] is served by nobody: serving
    without that shard, the reference of the degraded-mode tests)."""

    def __init__(self, n_shards, n_hosts, replication=1, replicas=None):
        if n_hosts < 1 or n_shards < 1:
            raise ValueError(f"need >=1 hosts and shards, got "
                             f"{n_hosts}/{n_shards}")
        if not (1 <= replication <= n_hosts):
            raise ValueError(f"replication {replication} must be in "
                             f"[1, n_hosts={n_hosts}]")
        self.n_shards, self.n_hosts = int(n_shards), int(n_hosts)
        self.replication = int(replication)
        if replicas is None:
            replicas = {s: [(s + r) % n_hosts for r in range(replication)]
                        for s in range(n_shards)}
        else:
            replicas = {int(s): list(hs) for s, hs in replicas.items()}
            for s in range(n_shards):
                replicas.setdefault(s, [])
        self.replicas = replicas

    def hosts_for(self, shard):
        return list(self.replicas[int(shard)])

    def shards_of(self, host):
        return sorted(s for s, hs in self.replicas.items() if host in hs)


# ---------------------------------------------------------------------------
# host tier
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HostRequest:
    generation: int
    mode: str                    # "adc" | "dot"
    q_or_lut: np.ndarray         # (B, nsub, 256) LUT or (B, dim) queries
    sel_ids: np.ndarray          # (B, S) selected cluster ids
    mine: np.ndarray             # (B, S) bool: selected AND owned here
    uniq: np.ndarray             # sorted unique owned cluster ids to fetch
    trace: bool = False          # record host-side span timings


@dataclasses.dataclass
class HostResponse:
    host_id: int
    generation: int
    ids: np.ndarray              # (B, Kp) int64, (score desc, id asc)
    scores: np.ndarray           # (B, Kp) float32, -inf padding
    # host-side span records when req.trace (else None): list of
    # {"name", "t0" (absolute perf_counter at span start), "dur_ms",
    #  "parent" (local index, -1 = root), "annot"}; record 0 is the
    # "host_serve" root. Hosts are threads of this process, so their
    # perf_counter is the router's clock.
    spans: Any = None


class HostDown(RuntimeError):
    pass


@dataclasses.dataclass
class _HostGen:
    store: Any
    cache: Optional[BlockCache]


class EngineHost:
    """One serving host: a shard-subset store and BlockCache behind the
    fetch -> score -> partial top-k steps, driven through a single-worker
    executor. The HostRequest/HostResponse boundary is the wire: numpy
    in, numpy out; the score step runs on `device` (None: the CUDA card)
    on this host's own stream.

    Fault injection:
      kill()/revive()            — hard down: every serve raises HostDown
      inject_delay(ms, times=N)  — the next N serves sleep first
      sim_latency=(base_ms, per_block_ms) — every serve sleeps
          base + per_block * len(uniq) (a remote block store's RTT and
          payload time)."""

    def __init__(self, host_id, reader, shard_ids, *, cache_capacity=512,
                 use_adc=None, sim_latency=None, sleep=time.sleep,
                 device=None):
        if not shard_ids:
            raise ValueError(f"host {host_id} owns no shards; use fewer "
                             f"hosts or more index shards")
        self.device = resolve_device(device)
        self.host_id = int(host_id)
        self.shard_ids = sorted(int(s) for s in shard_ids)
        self._cache_capacity = int(cache_capacity)
        self._use_adc = bool(reader.is_pq) if use_adc is None else bool(use_adc)
        self.sim_latency = sim_latency
        self._sleep = sleep
        self._lock = threading.Lock()
        self._gens: Dict[int, _HostGen] = {}
        # (generation, mode, B, U, S) keys of the score shapes served, as
        # the JAX host keys its compiled functions; retired with their
        # generation
        self._fns: Dict[Any, Any] = {}
        self._alive = True
        self._delay_ms = 0.0
        self._delay_times = 0
        self.served = 0
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"host{host_id}")
        self.prepare_generation(reader, reader.generation).result()

    # -- lifecycle ----------------------------------------------------------

    @property
    def alive(self):
        return self._alive

    def kill(self):
        self._alive = False

    def revive(self):
        self._alive = True

    def inject_delay(self, ms, times=1):
        with self._lock:
            self._delay_ms = float(ms)
            self._delay_times = int(times)

    def close(self):
        self._exec.shutdown(wait=True)

    def prepare_generation(self, reader, generation):
        """Open the reader's current manifest state as `generation` on this
        host, beside the generations already serving (blue/green). Runs
        through the serve queue, so it serializes with in-flight requests
        on this host. Returns the future."""
        return self._exec.submit(self._prepare, reader, int(generation))

    def _prepare(self, reader, generation):
        store = reader.open_store(shards=self.shard_ids)
        cache = None
        if self._cache_capacity:
            cache = BlockCache(self._cache_capacity * int(store.cap)
                               * int(store.dim) * 4)
        with self._lock:
            self._gens[generation] = _HostGen(store, cache)
        return generation

    def retire_generation(self, generation):
        """Drop a generation's store, cache and score keys through the
        serve queue: every request enqueued before the retire (which can
        only be for an older generation) is served first."""
        def _retire():
            with self._lock:
                self._gens.pop(int(generation), None)
                for key in [k for k in self._fns if k[0] == int(generation)]:
                    del self._fns[key]
        return self._exec.submit(_retire)

    def generations(self):
        with self._lock:
            return sorted(self._gens)

    # -- serving ------------------------------------------------------------

    def submit(self, req: HostRequest):
        """Enqueue a request on this host's serve queue; returns a Future
        resolving to a HostResponse (or raising HostDown)."""
        return self._exec.submit(self._serve, req)

    @staticmethod
    def _pow2(n):
        b = 1
        while b < n:
            b *= 2
        return b

    def _score(self, generation, mode, q_or_lut, blocks, pos):
        """(B, S, cap) float32 numpy scores of the compacted slots, by the
        engine's fused-tail kernel for `mode`, on this host's stream and
        finished before they return."""
        B, S = pos.shape
        self._fns.setdefault((generation, mode, B, self._pow2(len(blocks)),
                              S), True)
        score = adc_score_blocks if mode == "adc" else cluster_score
        dev = self.device
        stream = torch.cuda.stream(self._stream) if self._stream is not None \
            else contextlib.nullcontext()
        with torch.inference_mode(), stream:
            # a read-only wire array is copied: torch takes no such array
            out = score(torch.from_numpy(np.require(q_or_lut,
                                                    requirements="W")).to(dev),
                        torch.from_numpy(blocks).to(dev),
                        torch.from_numpy(pos.astype(np.int32)).to(dev))
            scores = out.cpu()
        if self._stream is not None:
            self._stream.synchronize()
        return scores.numpy()

    def _serve(self, req: HostRequest):
        if not self._alive:
            raise HostDown(f"host {self.host_id} is down")
        with self._lock:
            gen = self._gens.get(req.generation)
            delay = 0.0
            if self._delay_times > 0:
                delay = self._delay_ms
                self._delay_times -= 1
        if gen is None:
            raise HostDown(f"host {self.host_id} lacks generation "
                           f"{req.generation} (has {self.generations()})")
        # host-side span records, grafted by the router under its scatter
        # span; opened before the injected sleeps so host_serve covers
        # the host's whole wall time for this request
        spans = None
        if req.trace:
            spans = [{"name": "host_serve", "t0": time.perf_counter(),
                      "dur_ms": 0.0, "parent": -1,
                      "annot": {"generation": req.generation}}]

        def _rec(name, t0, **annot):
            if spans is not None:
                spans.append({"name": name, "t0": t0,
                              "dur_ms": (time.perf_counter() - t0) * 1e3,
                              "parent": 0, "annot": annot})
        if delay:
            self._sleep(delay / 1e3)
        if self.sim_latency:
            base_ms, per_block_ms = self.sim_latency
            self._sleep((base_ms + per_block_ms * len(req.uniq)) / 1e3)
        store, cache = gen.store, gen.cache
        uniq = np.asarray(req.uniq, np.int64)
        if uniq.size:
            fetch = pipe_lib.fetch_unique_code_blocks if req.mode == "adc" \
                else pipe_lib.fetch_unique_blocks
            t0 = time.perf_counter()
            blocks = fetch(store, uniq, cache)
            _rec("block_fetch", t0, n_blocks=int(uniq.size),
                 bytes=int(blocks.nbytes))
        else:
            blocks = np.zeros(
                (1, store.cap,
                 store.nsub if req.mode == "adc" else store.dim),
                np.uint8 if req.mode == "adc" else np.float32)
            uniq = np.zeros((1,), np.int64)
        sel = np.asarray(req.sel_ids)
        mine = np.asarray(req.mine, bool)
        B, S = sel.shape
        # compact each row's columns down to this host's own slots (a
        # power of two of them): scoring is per slot, so dropping the
        # other hosts' columns changes no kept score bit. The stable
        # argsort keeps slot order.
        t0 = time.perf_counter()
        sc = self._pow2(max(int(mine.sum(axis=1).max()), 1))
        if sc < S:
            keep = np.argsort(~mine, axis=1, kind="stable")[:, :sc]
            sel = np.take_along_axis(sel, keep, axis=1)
            mine = np.take_along_axis(mine, keep, axis=1)
            S = sc
        pos = np.searchsorted(uniq, np.where(mine, sel, uniq[0]))
        _rec("compact", t0, n_slots=int(S))
        t0 = time.perf_counter()
        scores3 = self._score(req.generation, req.mode,
                              np.asarray(req.q_or_lut), blocks, pos)
        _rec("score", t0, mode=req.mode)
        t0 = time.perf_counter()
        docs = store.cluster_docs_np[sel]                  # (B, S, cap)
        cap = docs.shape[-1]
        valid = (docs >= 0) & mine[:, :, None]
        flat_ids = np.where(valid, docs, MERGE_SENTINEL) \
            .reshape(B, S * cap).astype(np.int64)
        flat_ss = np.where(valid.reshape(B, S * cap),
                           scores3.reshape(B, S * cap),
                           -np.inf).astype(np.float32)
        # partial top-k on the host, np.lexsort's (score desc, id asc) with
        # -0.0 == +0.0; the all-pad tail is cut
        order = np.lexsort((flat_ids, -flat_ss), axis=-1)
        kp = max(1, int(valid.reshape(B, -1).sum(axis=1).max()))
        order = order[:, :kp]
        _rec("partial_topk", t0, kp=int(kp))
        self.served += 1
        if spans is not None:
            spans[0]["dur_ms"] = \
                (time.perf_counter() - spans[0]["t0"]) * 1e3
        return HostResponse(
            host_id=self.host_id, generation=req.generation,
            ids=np.take_along_axis(flat_ids, order, axis=-1),
            scores=np.take_along_axis(flat_ss, order, axis=-1),
            spans=spans)

    # -- introspection ------------------------------------------------------

    def stats(self):
        with self._lock:
            gens = sorted(self._gens)
            out = {"host": self.host_id, "alive": self._alive,
                   "shards": self.shard_ids, "served": self.served,
                   "generations": gens}
            newest = self._gens.get(gens[-1]) if gens else None
        if newest is not None:
            io = newest.store.stats
            out["io"] = {"n_ops": io.n_ops, "bytes": io.bytes}
            if newest.cache is not None:
                out["cache"] = newest.cache.stats()
        return out


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

class ShardRouter:
    """Scatter-gather front end over a fleet of EngineHost-compatible
    handles. Sparse retrieval, Stage I/II and (v2) the ADC LUT build run
    at the router on `device`; each batch's selected slots are scattered
    to the hosts owning their shards, the partial top-k lists gathered,
    merged under (score desc, id asc) and fused with the sparse side. See
    the module docstring for exactness, failover and generation hops."""

    def __init__(self, cfg, index, reader, hosts, placement, *,
                 max_batch=256, k=None, metrics=None, tracer=None,
                 trace_sample_rate=None, fusion=None, explain=None,
                 host_timeout=10.0, max_retries=3, backoff_ms=20.0,
                 host_cooldown=2.0, sleep=time.sleep, device=None):
        if fusion is not None and fusion not in FUSION_METHODS:
            raise ValueError(f"fusion must be one of {FUSION_METHODS}, "
                             f"got {fusion!r}")
        self._fusion_override = fusion
        self.device = resolve_device(device)
        self.cfg = self._apply_cfg_overrides(cfg)
        self.index = index.to(self.device)
        self.reader = reader
        self.hosts: List[Any] = list(hosts)
        self.placement = placement
        if placement.n_hosts != len(self.hosts):
            raise ValueError(f"placement maps {placement.n_hosts} hosts, "
                             f"got {len(self.hosts)}")
        self.max_batch = max(1, max_batch)
        self.k = k or self.cfg.k_final
        self.use_adc = bool(reader.is_pq)
        self.host_timeout = float(host_timeout)
        self.max_retries = int(max_retries)
        self.backoff_ms = float(backoff_ms)
        self.host_cooldown = float(host_cooldown)
        self._sleep = sleep
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if tracer is None:
            tracer = Tracer(sample_rate=trace_sample_rate or 0.0)
        elif trace_sample_rate is not None:
            tracer.sample_rate = float(trace_sample_rate)
        self.tracer = tracer
        # sampled explain records (repro_torch.obs.ExplainLogger); the
        # router's add per-host attribution (host_contrib)
        self.explain = explain
        self.serve_stats = ServeStats(self.metrics)
        self._failed = self.metrics.counter("router.failed_requests")
        self._degraded = self.metrics.counter("router.degraded_requests")
        self._retries = self.metrics.counter("router.retries")
        self._failovers = self.metrics.counter("router.failovers")
        self._swap_lock = threading.RLock()
        self._fns: Dict[Any, Any] = {}
        self._generation = reader.generation
        self._shard_his = self._read_shard_his(reader)
        # per-host health: monotonic time before which the host is skipped
        self._down_until = collections.defaultdict(float)
        # per-batch metadata ring: generation served, degraded flag,
        # shards with no live replica, hosts used, retries
        self.last_batches = collections.deque(maxlen=256)

    @staticmethod
    def _read_shard_his(reader):
        return np.asarray([s["cluster_hi"]
                           for s in reader.manifest["block_shards"]],
                          np.int64)

    def _apply_cfg_overrides(self, cfg):
        if self._fusion_override is not None \
                and cfg.fusion != self._fusion_override:
            cfg = dataclasses.replace(cfg, fusion=self._fusion_override)
        return cfg

    @classmethod
    def local(cls, reader, n_hosts, replication=1, *, cfg=None, index=None,
              cache_capacity=512, sim_latency=None, placement=None,
              device=None, **router_kw):
        """A router over `n_hosts` EngineHosts in this process serving the
        reader's index with the default placement rule, on `device`
        (None: the CUDA card)."""
        dev = resolve_device(device)
        if index is None:
            loaded_cfg, index = reader.load_index(device=dev)
            cfg = cfg if cfg is not None else loaded_cfg
        cfg = cfg if cfg is not None else reader.config()
        if placement is None:
            placement = ShardPlacement(reader.n_block_shards(), n_hosts,
                                       replication)
        hosts = [EngineHost(h, reader, placement.shards_of(h),
                            cache_capacity=cache_capacity,
                            sim_latency=sim_latency, device=dev)
                 for h in range(n_hosts)]
        return cls(cfg, index, reader, hosts, placement, device=dev,
                   **router_kw)

    def close(self):
        for h in self.hosts:
            close = getattr(h, "close", None)
            if close:
                close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- router stages -------------------------------------------------------

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
        return self._fn("lut", bucket, lambda: pipe_lib.build_lut_fn(
            self.reader._pq_array("codebooks"),
            self.reader._pq_array("rotation"), self.device))

    def _fuse_fn(self, bucket, kd):
        """Fuse the merged dense list with the sparse side: the fuse_topk
        scatter the single-host fused tail ends in."""
        def build():
            cfg, n_docs, k = self.cfg, self.index.n_docs, self.k

            def run(sid, ss, did, dscore, dmask):
                return fusion_lib.fuse_topk(
                    sid, ss, did, torch.where(dmask, dscore, 0.0), dmask,
                    n_docs, cfg.alpha, k, method=cfg.fusion, rrf_k=cfg.rrf_k)
            return run
        return self._fn("fuse", (bucket, kd), build)

    # -- failover helpers ---------------------------------------------------

    def _host_live(self, h, now):
        return self.hosts[h].alive and self._down_until[h] <= now

    def _pick_host(self, shard, tried):
        """A replica for `shard`: a live host not yet tried this request;
        else a live one again (timeouts may be transient); else a host in
        cooldown that is not killed (cooldown must not turn a transient
        timeout into an outage); else nobody (None)."""
        now = time.monotonic()
        replicas = self.placement.hosts_for(shard)
        for h in replicas:
            if h not in tried and self._host_live(h, now):
                return h
        for h in replicas:
            if self._host_live(h, now):
                return h
        for h in replicas:
            if self.hosts[h].alive:
                return h
        return None

    def _mark_failed(self, h):
        self._down_until[h] = time.monotonic() + self.host_cooldown

    def missing_shards(self):
        """Shards with no live replica right now (degraded mode while
        non-empty: their slots are skipped, requests still complete)."""
        return sorted(
            s for s in range(self.placement.n_shards)
            if not any(self.hosts[h].alive
                       for h in self.placement.hosts_for(s)))

    # -- serving ------------------------------------------------------------

    def retrieve(self, q_dense, q_terms, q_weights, *, k=None):
        """Serve a query batch of any size. Returns (ids, scores) on the
        router's device with the caller's batch dimension preserved."""
        if k is not None and k != self.k:
            raise ValueError("per-call k would defeat bucketed compilation; "
                             "construct the router with the serving k")
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
        with self._swap_lock, torch.inference_mode():
            try:
                return self._retrieve_locked(q_dense, q_terms, q_weights)
            except Exception:
                self._failed.inc()
                raise

    def _retrieve_locked(self, q_dense, q_terms, q_weights):
        n = int(q_dense.shape[0])
        bucket = bucket_size(n, self.max_batch)
        self._built_fn = False
        generation = self._generation
        dev = self.device
        tr = self.tracer.trace("batch", size=n, bucket=bucket,
                               generation=generation)
        with tr.span("pad"):
            pad = bucket - n
            qd = torch.tensor(_pad_rows(q_dense, pad),
                              dtype=torch.float32).to(dev)
            qt = torch.tensor(_pad_rows(q_terms, pad),
                              dtype=torch.int32).to(dev)
            qw = torch.tensor(_pad_rows(q_weights, pad),
                              dtype=torch.float32).to(dev)
            synchronize(dev)
        t0 = time.perf_counter()
        with tr.span("stage1"):
            sid, ss, cand, feats = self._stage1_fn(bucket)(qd, qt, qw)
            synchronize(dev)
        q_or_lut = qd
        if self.use_adc:
            with tr.span("lut_build"):
                q_or_lut = self._lut_fn(bucket)(qd)
                synchronize(dev)
        with tr.span("stage2_select"):
            sel_ids, sel_mask, probs = self._stage2_fn(bucket)(cand, feats)
            sel_np = sel_ids.cpu().numpy()
            mask_np = sel_mask.cpu().numpy()
        mode = "adc" if self.use_adc else "dot"
        q_host = q_or_lut.cpu().numpy()
        # slot ownership: shard = searchsorted over manifest cluster_hi
        shard_of = np.searchsorted(self._shard_his,
                                   np.where(mask_np, sel_np, 0),
                                   side="right")
        responses, meta = self._scatter_gather(
            generation, mode, q_host, sel_np, mask_np, shard_of, tr)
        B, S = sel_np.shape
        cap = int(self.index.cluster_docs.shape[1])
        kd = S * cap
        with tr.span("merge", n_parts=len(responses)):
            if responses:
                mids, mscores = merge_partial_topk(
                    [(r.ids, r.scores) for r in responses], kd)
            else:
                mids = np.full((B, kd), MERGE_SENTINEL, np.int64)
                mscores = np.full((B, kd), -np.inf, np.float32)
            dmask = np.isfinite(mscores)
            did = np.where(dmask, mids, 0).astype(np.int32)
            dscore = np.where(dmask, mscores, 0.0).astype(np.float32)
        with tr.span("fuse"):
            ids, scores = self._fuse_fn(bucket, kd)(
                sid, ss, torch.from_numpy(did).to(dev),
                torch.from_numpy(dscore).to(dev),
                torch.from_numpy(dmask).to(dev))
            synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        gens = {r.generation for r in responses} or {generation}
        if gens != {generation}:
            raise RuntimeError(f"mixed-generation responses: {gens} (router "
                               f"at {generation})")
        meta.update(generation=generation, size=n, bucket=bucket)
        self.last_batches.append(meta)
        if meta["degraded"]:
            self._degraded.inc()
        if self.explain is not None and self.explain.sample():
            recs = build_explain_records(
                self.cfg, qid_base=self.serve_stats.n_queries,
                generation=generation, n=n, cand=cand, probs=probs,
                sel_ids=sel_np, sel_mask=mask_np, final_ids=ids,
                sparse_ids=sid, doc_cluster=self.index.doc_cluster)
            final_np = ids[:n].cpu().numpy()
            for i, rec in enumerate(recs):
                fset = {int(x) for x in final_np[i] if int(x) >= 0}
                contrib = {}
                for r in responses:
                    hit = len(fset & {int(x) for x in r.ids[i]
                                      if 0 <= int(x) < MERGE_SENTINEL})
                    if hit:
                        key = str(r.host_id)
                        contrib[key] = contrib.get(key, 0) + hit
                rec["host_contrib"] = contrib
                rec["degraded"] = meta["degraded"]
                self.explain.emit(rec)
        tr.finish(compiled=self._built_fn, batch_ms=round(ms, 3),
                  degraded=meta["degraded"])
        self.serve_stats.record(n, bucket, self._built_fn, ms)
        return ids[:n], scores[:n]

    def _scatter_gather(self, generation, mode, q_host, sel_np, mask_np,
                        shard_of, tr):
        """Scatter per-shard slot groups to live replicas, gather partial
        top-k responses with timeout, retry, backoff and replica failover.
        Returns (responses, meta)."""
        # pending: shard -> (B, S) bool slot mask still unserved
        pending = {}
        for s in np.unique(shard_of[mask_np]):
            pending[int(s)] = mask_np & (shard_of == int(s))
        meta = {"degraded": False, "missing_shards": [], "hosts": [],
                "retries": 0}
        responses = []
        if not pending:
            with tr.span("scatter", n_hosts=0):
                with tr.span("gather", n_hosts=0):
                    pass
            return responses, meta
        # hosts record spans only when this batch itself is traced
        trace_hosts = tr is not NOOP_TRACE
        tried = {s: set() for s in pending}
        attempt = 0
        while pending:
            # the scatter span covers the gather (its child), so the host
            # spans grafted under scatter fall inside its window
            with tr.span("scatter", attempt=attempt,
                         n_shards=len(pending)) as sp:
                groups = {}
                for s in sorted(pending):
                    h = self._pick_host(s, tried[s])
                    if h is None:
                        continue
                    if h != self.placement.hosts_for(s)[0]:
                        # a non-primary replica serves it (the primary is
                        # dead, cooling down, or tried this request)
                        self._failovers.inc()
                    groups.setdefault(h, []).append(s)
                futures = {}
                for h, shards in groups.items():
                    mine = np.zeros_like(mask_np)
                    for s in shards:
                        mine |= pending[s]
                    uniq = np.unique(sel_np[mine]) if mine.any() \
                        else np.zeros((0,), np.int64)
                    req = HostRequest(generation=generation, mode=mode,
                                      q_or_lut=q_host, sel_ids=sel_np,
                                      mine=mine, uniq=uniq,
                                      trace=trace_hosts)
                    futures[h] = (shards, self.hosts[h].submit(req))
                sp.annotate(n_hosts=len(futures))
                if not futures:    # every pending shard has no live replica
                    break
                with tr.span("gather", attempt=attempt,
                             n_hosts=len(futures)):
                    deadline = time.monotonic() + self.host_timeout
                    for h, (shards, fut) in futures.items():
                        try:
                            resp = fut.result(
                                timeout=max(0.0,
                                            deadline - time.monotonic()))
                            if resp.generation != generation:
                                raise HostDown(
                                    f"host {h} answered generation "
                                    f"{resp.generation} for {generation}")
                        except Exception:
                            # timeout, HostDown or a host-side error: a
                            # late response is never merged; mark the host
                            # and fail its shards over to a replica
                            fut.cancel()
                            self._mark_failed(h)
                            for s in shards:
                                tried[s].add(h)
                            continue
                        responses.append(resp)
                        meta["hosts"].append(h)
                        for s in shards:
                            pending.pop(s, None)
                        if resp.spans:
                            self._graft_host_spans(tr, sp, h, resp.spans)
            if pending:
                if attempt >= self.max_retries:
                    break
                self._retries.inc()
                meta["retries"] += 1
                self._sleep(self.backoff_ms * (2 ** attempt) / 1e3)
                attempt += 1
        if pending:
            # no live replica for these shards: complete without them,
            # exactly "serving without that shard"
            meta["degraded"] = True
            meta["missing_shards"] = sorted(pending)
        return responses, meta

    @staticmethod
    def _graft_host_spans(tr, scatter_sp, host_id, records):
        """Attach one host's completed span records under the router's
        open scatter span, keeping the host-local parent structure; every
        grafted span is annotated host=<id> (the Chrome exporter gives
        each host its own lane)."""
        grafted = {}
        for j, rec in enumerate(records):
            parent = scatter_sp if rec["parent"] < 0 \
                else grafted[rec["parent"]]
            grafted[j] = tr.add_completed(
                rec["name"], t0_abs=rec["t0"], dur_ms=rec["dur_ms"],
                parent=parent, host=int(host_id), **rec["annot"])

    # -- generation hops ----------------------------------------------------

    def reload_index(self, *, verify="none"):
        """Roll the fleet to the index's current committed generation host
        by host with zero failed requests: prepare the new generation on
        every host (the old keeps serving), flip the router's arrays and
        stage functions under its lock, then retire the old generation
        through each host's serve queue. Returns the generation served."""
        tr = self.tracer.trace("reload_index")
        with tr.span("reload"):
            old_gen = self._generation
            self.reader.refresh(verify=verify)
            new_gen = self.reader.generation
            if new_gen == old_gen:
                tr.finish(generation=old_gen)
                return old_gen
            cfg, index = self.reader.load_index(device=self.device)
            cfg = self._apply_cfg_overrides(cfg)
            for host in self.hosts:        # roll host by host
                with tr.span("prepare_host", host=host.host_id):
                    host.prepare_generation(self.reader, new_gen).result()
            with self._swap_lock:
                self.cfg, self.index = cfg, index
                self.use_adc = bool(self.reader.is_pq)
                self._shard_his = self._read_shard_his(self.reader)
                self._fns.clear()
                self._generation = new_gen
                self.serve_stats.record_reload()
            for host in self.hosts:
                host.retire_generation(old_gen)
        tr.finish(generation=new_gen)
        return new_gen

    def reload_selector(self, *, verify="none"):
        """Hot-swap only the Stage-II selector (selection runs at the
        router): adopt a newer generation's LSTM weights and calibrated
        theta/budget. Falls back to `reload_index()` when the arrays or
        block shards moved too."""
        from repro_torch.convert import selector_from_numpy
        before = (self.reader.manifest.get("arrays"),
                  self.reader.manifest.get("block_shards"))
        self.reader.refresh(verify=verify)
        after = (self.reader.manifest.get("arrays"),
                 self.reader.manifest.get("block_shards"))
        if before != after:
            return self.reload_index(verify="none")
        if self.reader.generation == self._generation:
            return self._generation
        cfg = self._apply_cfg_overrides(self.reader.config())
        params = self.reader.lstm_params()
        selector = None if params is None \
            else selector_from_numpy(params, device=self.device)
        # a selector publish is still a generation hop: hosts key their
        # stores by generation, so they adopt it too (content-identical,
        # an mmap open)
        old_gen = self._generation
        for host in self.hosts:
            host.prepare_generation(self.reader, self.reader.generation) \
                .result()
        with self._swap_lock:
            old_cfg = self.cfg
            self.cfg = cfg
            self.index.selector = selector
            stale = {"stage2", "fuse"}
            if RetrievalEngine._stage1_cfg(old_cfg) != \
                    RetrievalEngine._stage1_cfg(cfg):
                stale.add("stage1")
            for key in [k for k in self._fns if k[0] in stale]:
                del self._fns[key]
            self._generation = self.reader.generation
            self.serve_stats.record_selector_reload()
        for host in self.hosts:
            host.retire_generation(old_gen)
        return self.reader.generation

    # -- introspection ------------------------------------------------------

    def _sync_gauges(self):
        """Mirror router and per-host state into registry gauges, so one
        metrics export (`--metrics-out`, a /metrics scrape) covers the
        fleet: `host<i>.cache.*`, `host<i>.io.*`, `host<i>.alive`,
        `host<i>.served`."""
        reg = self.metrics
        missing = self.missing_shards()
        reg.gauge("router.generation").set(self._generation)
        reg.gauge("router.missing_shards").set(len(missing))
        reg.gauge("router.hosts_alive").set(
            sum(1 for h in self.hosts if h.alive))
        for h in self.hosts:
            st = h.stats()
            i = st["host"]
            reg.gauge(f"host{i}.alive").set(int(st["alive"]))
            reg.gauge(f"host{i}.served").set(int(st["served"]))
            for k, v in (st.get("cache") or {}).items():
                if isinstance(v, (int, float)):
                    reg.gauge(f"host{i}.cache.{k}").set(v)
            for k, v in (st.get("io") or {}).items():
                if isinstance(v, (int, float)):
                    reg.gauge(f"host{i}.io.{k}").set(v)
        return missing

    def stats(self):
        ss = self.serve_stats
        missing = self._sync_gauges()
        out = {"n_queries": ss.n_queries,
               "n_batches": ss.n_batches,
               "n_compile_batches": ss.n_compile_batches,
               "qps_steady": round(ss.steady_qps(), 1),
               "generation": self._generation,
               "hosts": len(self.hosts),
               "replication": self.placement.replication,
               "n_shards": self.placement.n_shards,
               "failed_requests": int(self._failed.value),
               "degraded_requests": int(self._degraded.value),
               "retries": int(self._retries.value),
               "failovers": int(self._failovers.value),
               "missing_shards": missing,
               "degraded": bool(missing),
               "reloads": ss.reloads,
               "selector_reloads": ss.selector_reloads,
               "fusion": self.cfg.fusion,
               "use_adc": self.use_adc,
               **ss.latency_percentiles()}
        out["per_host"] = [h.stats() for h in self.hosts]
        return out

    def reset_stats(self):
        with self._swap_lock:
            self.metrics.reset()
            self.serve_stats.reset()
            self.last_batches.clear()
