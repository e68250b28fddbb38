"""Sharded on-disk ClusterStores over a built index's per-shard block
files, with the JAX package's routing and I/O accounting.

Shard s memmaps `blocks/shard_s.bin` (v1) or `.codes.bin` (v2), owning
clusters [lo_s, hi_s).
A fetch routes each requested cluster to its shard and coalesces runs of
adjacent cluster ids *within* a shard into single contiguous memmap
reads — `IOStats.n_ops` counts runs, not blocks. Stats are thread-safe so
the engine's background prefetcher can share the store with serving.

Two record encodings behind the same routing:

  * ShardedDiskStore (format v1): one (cap, dim) float block per cluster,
    stored as float32 (returned as read), bfloat16 (read as uint16 bits
    and widened by hand: the card machine has no ml_dtypes) or int8
    (`record * block_scale`).
  * ShardedPQStore (format v2): one (cap, nsub) uint8 code block per
    cluster. `fetch_code_blocks` returns the RAW codes (`is_coded=True`):
    the engine caches codes and scores them on the device via ADC lookup
    tables (repro_torch.kernels.adc). `fetch_blocks` decodes through the
    codebooks on the host.
"""

import threading
import time

import numpy as np
import torch

from repro_torch.core.disk import IOStats, read_blocks_coalesced
from repro_torch.core.quant import decode_code_blocks
from repro_torch.index.format import (bf16_bits_to_f32, f32_to_bf16_bits,
                                      record_dtype, resolve_block_dtype)


class _ShardedBlockFiles:
    """Shared routing + run-coalescing over per-shard fixed-record files."""

    is_host = True
    is_coded = False

    def __init__(self, shard_paths, shard_ranges, record_shape, record_dtype,
                 cluster_docs, tombstones=None, stats: IOStats = None):
        if len(shard_paths) != len(shard_ranges) or not shard_paths:
            raise ValueError("need one path per shard range")
        self.record_shape = tuple(int(x) for x in record_shape)
        self.record_dtype = np.dtype(record_dtype)
        self._lo = np.asarray([lo for lo, _ in shard_ranges], np.int64)
        self._hi = np.asarray([hi for _, hi in shard_ranges], np.int64)
        # ascending and non-overlapping; gaps are allowed (a store over a
        # subset of the shards), and fetching a cluster in a gap raises
        if np.any(self._lo >= self._hi) or np.any(self._lo[1:] < self._hi[:-1]):
            raise ValueError(f"shard ranges must be ascending and "
                             f"non-overlapping: "
                             f"{list(zip(self._lo, self._hi))}")
        self.n_clusters = int(self._hi[-1])
        self.owned_ranges = [(int(lo), int(hi))
                             for lo, hi in zip(self._lo, self._hi)]
        self._mms = [
            np.memmap(p, dtype=self.record_dtype, mode="r",
                      shape=(int(hi - lo),) + self.record_shape)
            for p, (lo, hi) in zip(shard_paths, shard_ranges)]
        # tombstoned slots read as docs=-1/valid=False; their bytes stay
        cd = np.asarray(cluster_docs)
        if tombstones is not None:
            tomb = np.asarray(tombstones)
            if tomb.shape != cd.shape:
                raise ValueError(f"tombstones shape {tomb.shape} != "
                                 f"cluster_docs shape {cd.shape}")
            cd = np.where(tomb > 0, -1, cd)
        self.tombstones = tombstones
        self.cluster_docs_np = cd
        self.cluster_docs = torch.from_numpy(np.array(cd))
        self.block_bytes = int(np.prod(self.record_shape)) * \
            self.record_dtype.itemsize
        self.stats = stats if stats is not None else IOStats()
        self.decode_ms = 0.0          # host decode time, outside IOStats
        self._lock = threading.Lock()

    @property
    def n_shards(self):
        return len(self._mms)

    def _decode(self, records):
        """(n,) + record_shape raw records -> (n, cap, dim) float blocks."""
        return records

    def _empty_blocks(self):
        return np.zeros((0,) + self.record_shape, self.record_dtype)

    def _fetch_records(self, cluster_ids):
        """1-D host sequence of cluster ids -> (raw records, docs, valid).
        Routes to shards, reads coalesced runs and charges IOStats."""
        ids = np.asarray(cluster_ids, np.int64).reshape(-1)
        docs = self.cluster_docs_np[ids]
        valid = docs >= 0
        n = len(ids)
        if n == 0:
            return self._empty_blocks(), docs, valid
        t0 = time.perf_counter()
        out = np.empty((n,) + self.record_shape, self.record_dtype)
        sid = np.searchsorted(self._hi, ids, side="right")
        last = len(self._mms) - 1
        bad = (ids < 0) | (sid > last) | (ids < self._lo[np.minimum(sid, last)])
        if np.any(bad):
            raise KeyError(f"cluster ids {ids[bad][:8].tolist()} not owned by "
                           f"this store (owned ranges {self.owned_ranges})")
        # split at shard changes OR non-adjacent ids; coalesce inside a run
        brk = np.flatnonzero((np.diff(ids) != 1) | (np.diff(sid) != 0)) + 1
        bounds = np.concatenate([[0], brk, [n]])
        n_ops = 0
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            s = int(sid[lo])
            local = ids[lo:hi] - self._lo[s]
            _, runs = read_blocks_coalesced(self._mms[s], local, out,
                                            out_offset=int(lo))
            n_ops += runs
        with self._lock:
            self.stats.add(n_ops, n * self.block_bytes,
                           (time.perf_counter() - t0) * 1e3)
        return out, docs, valid

    def fetch_blocks(self, cluster_ids):
        """1-D host sequence of cluster ids -> (vecs, docs, valid)."""
        records, docs, valid = self._fetch_records(cluster_ids)
        t1 = time.perf_counter()
        vecs = self._decode(records)
        with self._lock:
            self.decode_ms += (time.perf_counter() - t1) * 1e3
        return vecs, docs, valid

    def fetch_clusters(self, cluster_ids, stats: IOStats = None):
        """Blocks only, as a CPU float tensor; `stats` is an optional extra
        sink (the store's own IOStats always accumulates)."""
        t0 = time.perf_counter()
        before = (self.stats.n_ops, self.stats.bytes)
        vecs, _, _ = self.fetch_blocks(cluster_ids)
        if stats is not None:
            stats.add(self.stats.n_ops - before[0],
                      self.stats.bytes - before[1],
                      (time.perf_counter() - t0) * 1e3)
        return torch.from_numpy(np.ascontiguousarray(vecs))


class ShardedDiskStore(_ShardedBlockFiles):
    """Format-v1 backend: raw (cap, dim) cluster blocks in float32,
    bfloat16 or int8 (`dtype` names the block_dtype of the manifest),
    decoded to float32 on fetch."""

    def __init__(self, shard_paths, shard_ranges, cap, dim, cluster_docs,
                 dtype="float32", block_scale=None, tombstones=None,
                 stats: IOStats = None):
        self.block_dtype = resolve_block_dtype(dtype)
        super().__init__(shard_paths, shard_ranges, (int(cap), int(dim)),
                         record_dtype(self.block_dtype), cluster_docs,
                         tombstones=tombstones, stats=stats)
        self.cap, self.dim = int(cap), int(dim)
        if self.block_dtype == "int8":
            if block_scale is None:
                raise ValueError("int8 shards need the manifest geometry's "
                                 "block_scale to decode")
            self.block_scale = float(block_scale)
        else:
            self.block_scale = None

    def _decode(self, records):
        if self.block_dtype == "float32":
            return records
        if self.block_dtype == "int8":
            return records.astype(np.float32) * np.float32(self.block_scale)
        return bf16_bits_to_f32(records)


class ShardedPQStore(_ShardedBlockFiles):
    """Format-v2 backend: PQ code shards. `IOStats.bytes` counts CODE
    bytes — the 4*dim/nsub I/O reduction is visible there.

    `out_dtype` is the decoded blocks' type (the directory's
    `block_dtype`). "bfloat16" rounds the decoded floats to bfloat16 (to
    nearest even, by hand: the card machine has no ml_dtypes) and keeps
    them as float32 values, the values the JAX store's bfloat16 blocks
    hold."""

    is_coded = True

    def __init__(self, shard_paths, shard_ranges, cap, codebooks,
                 cluster_docs, rotation=None, out_dtype=np.float32,
                 tombstones=None, stats: IOStats = None):
        self.codebooks = np.asarray(codebooks, np.float32)
        if self.codebooks.ndim != 3:
            raise ValueError(f"codebooks must be (nsub, n_codes, dsub), "
                             f"got {self.codebooks.shape}")
        self.nsub = int(self.codebooks.shape[0])
        self.rotation = None if rotation is None \
            else np.asarray(rotation, np.float32)
        super().__init__(shard_paths, shard_ranges, (int(cap), self.nsub),
                         np.uint8, cluster_docs, tombstones=tombstones,
                         stats=stats)
        self.cap = int(cap)
        self.dim = int(self.nsub * self.codebooks.shape[2])
        self.round_bf16 = str(out_dtype) == "bfloat16"
        self.dtype = np.dtype(np.float32 if self.round_bf16 else out_dtype)

    def _decode(self, records):
        out = decode_code_blocks(self.codebooks, records, self.rotation)
        if self.round_bf16:
            return bf16_bits_to_f32(f32_to_bf16_bits(out))
        return out.astype(self.dtype, copy=False)

    def _empty_blocks(self):
        return np.zeros((0, self.cap, self.nsub), np.uint8)

    def fetch_code_blocks(self, cluster_ids):
        """Like fetch_blocks but returns the RAW (n, cap, nsub) uint8 code
        records — no host decode (decode_ms untouched)."""
        return self._fetch_records(cluster_ids)
