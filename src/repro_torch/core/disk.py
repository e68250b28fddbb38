"""On-disk embedding stores with cluster-block I/O (paper §2.1 and Table
4), after the JAX package's `core/disk.py`.

Clusters are stored as contiguous fixed-size blocks in one binary file,
so selecting S clusters costs S block reads, and a run of adjacent
cluster ids is one read (`read_blocks_coalesced`), against per-doc
random reads for reranking (`DiskDocStore`). The file's bytes are the
JAX store's: (n_clusters, cap, dim) float32 records, padded slots 0, as
`repro_torch.index.builder.pack_blocks` packs them.

IOStats' latency model uses the paper's constants (0.15 ms per I/O op on
their PCIe SSD, plus a 3 GB/s bandwidth term); `wall_ms` is measured.

  ondisk_clusd_retrieve   CluSD over a DiskClusterStore: selection on the
                          device, one deduplicated block fetch per batch
                          (engine.pipeline.retrieve with a DiskStore)
  ondisk_rerank_retrieve  S+Rerank: each query's sparse top-depth docs
                          read one by one from a DiskDocStore
"""

import dataclasses
import os
import time

import numpy as np
import torch

PER_OP_MS = 0.15          # paper: per-I/O-op queueing/software overhead
SSD_BW_GBPS = 3.0         # PCIe SSD sequential bandwidth


@dataclasses.dataclass
class IOStats:
    n_ops: int = 0
    bytes: int = 0
    wall_ms: float = 0.0

    def model_ms(self):
        return self.n_ops * PER_OP_MS + self.bytes / (SSD_BW_GBPS * 1e6)

    def add(self, ops, nbytes, wall):
        self.n_ops += ops
        self.bytes += nbytes
        self.wall_ms += wall


def read_blocks_coalesced(mm, ids, out=None, out_offset=0):
    """Copy blocks `mm[ids]` into `out`, coalescing runs of adjacent ids
    into single contiguous memmap reads. Returns (out, n_runs) — one I/O
    op per run, not per block."""
    ids = np.asarray(ids, np.int64)
    n = len(ids)
    if out is None:
        out = np.empty((n,) + mm.shape[1:], mm.dtype)
    if n == 0:
        return out, 0
    brk = np.flatnonzero(np.diff(ids) != 1) + 1
    bounds = np.concatenate([[0], brk, [n]])
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        out[out_offset + lo:out_offset + hi] = mm[ids[lo]:ids[lo] + (hi - lo)]
    return out, len(bounds) - 1


class DiskClusterStore:
    """Embeddings laid out cluster by cluster (padded to cap) in one
    float32 file.

    `pack()` writes the file once, offline, from a host (D, dim)
    embedding array (only member rows are read, a chunk of clusters at
    a time); `open()` reopens an existing file read-only, checking its
    size against (n_clusters, cap, dim)."""

    def __init__(self, path, embeddings=None, cluster_docs=None,
                 dtype=np.float32, *, n_clusters=None, cap=None, dim=None):
        self.path = path
        self.dtype = np.dtype(dtype)
        if self.dtype != np.float32:
            raise ValueError(f"DiskClusterStore stores float32 blocks, got "
                             f"{self.dtype}")
        if embeddings is not None:
            from repro_torch.index.builder import (DEFAULT_CHUNK_DOCS, _np,
                                                   _write_float_blocks)
            cd = _np(cluster_docs)
            self.n_clusters, self.cap = cd.shape
            self.dim = int(embeddings.shape[1])
            _write_float_blocks(path, embeddings, cd, "float32",
                                DEFAULT_CHUNK_DOCS)
        else:
            if n_clusters is None or cap is None or dim is None:
                raise ValueError(
                    "opening an existing store needs n_clusters/cap/dim")
            self.n_clusters, self.cap, self.dim = n_clusters, cap, dim
            expect = n_clusters * cap * dim * self.dtype.itemsize
            actual = os.path.getsize(path)
            if actual != expect:
                raise ValueError(f"{path}: expected {expect} bytes for "
                                 f"({n_clusters}, {cap}, {dim}) "
                                 f"{self.dtype}, found {actual}")
        self.block_bytes = self.cap * self.dim * self.dtype.itemsize
        self._mm = np.memmap(path, dtype=self.dtype, mode="r",
                             shape=(self.n_clusters, self.cap, self.dim))

    @classmethod
    def pack(cls, path, embeddings, cluster_docs, dtype=np.float32):
        """Write the block file from an embedding array (pack time)."""
        return cls(path, embeddings, cluster_docs, dtype)

    @classmethod
    def open(cls, path, n_clusters, cap, dim, dtype=np.float32):
        """Reopen an existing block file read-only (read time)."""
        return cls(path, dtype=dtype, n_clusters=n_clusters, cap=cap, dim=dim)

    def fetch_clusters(self, cluster_ids, stats: IOStats = None):
        """Read the given cluster blocks, one I/O op per run of adjacent
        ids. Returns a (S, cap, dim) float32 CPU tensor."""
        t0 = time.perf_counter()
        ids = np.asarray(cluster_ids, np.int64).reshape(-1)
        out, n_runs = read_blocks_coalesced(self._mm, ids)
        wall = (time.perf_counter() - t0) * 1e3
        if stats is not None:
            stats.add(n_runs, len(ids) * self.block_bytes, wall)
        return torch.from_numpy(out)


class DiskDocStore:
    """Per-document random access (the rerank / graph-navigation I/O
    pattern): one (dim,) float32 record per doc, one read per doc."""

    def __init__(self, path, embeddings, dtype=np.float32):
        emb = np.asarray(embeddings, dtype)
        emb.tofile(path)
        self.n_docs, self.dim = emb.shape
        self.dtype = dtype
        self.doc_bytes = self.dim * np.dtype(dtype).itemsize
        self._mm = np.memmap(path, dtype=dtype, mode="r",
                             shape=(self.n_docs, self.dim))

    def fetch_docs(self, doc_ids, stats: IOStats = None):
        """(len(doc_ids), dim) CPU tensor, one I/O op per doc."""
        t0 = time.perf_counter()
        out = np.stack([np.array(self._mm[d]) for d in doc_ids])
        wall = (time.perf_counter() - t0) * 1e3
        if stats is not None:
            stats.add(len(doc_ids), len(doc_ids) * self.doc_bytes, wall)
        return torch.from_numpy(out)


def ondisk_clusd_retrieve(cfg, index, store: DiskClusterStore, q_dense,
                          q_terms, q_weights, *, k=None, cache=None):
    """CluSD with the embedding store on disk: Stages I-II run on the
    index's device tensors; only the selected cluster blocks are read,
    deduplicated over the batch (through an engine BlockCache when
    given), and scored on the index's device by the cluster_score kernel.
    Returns (ids, scores, IOStats)."""
    from repro_torch.engine import pipeline as pipe_lib
    from repro_torch.engine import stores as stores_lib

    stats = IOStats()
    dstore = stores_lib.DiskStore(store, index.cluster_docs, stats=stats)
    ids, scores, _ = pipe_lib.retrieve(cfg, index, dstore, q_dense, q_terms,
                                       q_weights, k=k, cache=cache)
    return ids, scores, stats


def ondisk_rerank_retrieve(cfg, index, store: DiskDocStore, q_dense, q_terms,
                           q_weights, *, depth=1000, k=None):
    """S+Rerank with per-doc disk reads (Table 4 row 1): each query's
    sparse top-`depth` docs are read one by one, dot-scored and fused.
    Returns (ids, scores, IOStats)."""
    from repro_torch.core import fusion as fusion_lib
    from repro_torch.core import sparse as sparse_lib

    k = k or cfg.k_final
    stats = IOStats()
    sparse_ids, sparse_scores = sparse_lib.sparse_retrieve_topk(
        index.sparse_index, q_terms, q_weights, depth)
    dev = q_dense.device
    all_ids, all_scores = [], []
    for b in range(q_dense.shape[0]):
        vecs = store.fetch_docs(sparse_ids[b].cpu().numpy(), stats).to(dev)
        dscore = (vecs @ q_dense[b].float()).reshape(1, -1)
        mask = torch.ones_like(dscore, dtype=torch.bool)
        ids_b, sc_b = fusion_lib.fuse_topk(
            sparse_ids[b:b + 1], sparse_scores[b:b + 1],
            sparse_ids[b:b + 1], dscore, mask, index.n_docs, cfg.alpha, k)
        all_ids.append(ids_b[0])
        all_scores.append(sc_b[0])
    return torch.stack(all_ids), torch.stack(all_scores), stats
