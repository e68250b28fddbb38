"""Cluster-block storage backends behind one protocol.

  fetch_blocks(cluster_ids) -> (vecs, docs, valid)
    cluster_ids : int cluster ids; device stores take a tensor of any
                  leading shape, host stores a 1-D host sequence
    vecs  : (..., cap, dim) float32 block embeddings
    docs  : (..., cap)      int32 doc ids, -1 pad
    valid : (..., cap)      bool  (docs >= 0)

Host backends (`is_host`) read from disk; the pipeline batches selection
on the device and fetches deduplicated blocks on the host. A code-backed
backend (`is_coded`) also answers `fetch_code_blocks(cluster_ids) ->
(codes, docs, valid)` with RAW (..., cap, nsub) uint8 code blocks and
exposes `codebooks`/`rotation`/`nsub`, so the pipeline scores codes via
ADC lookup tables without decoding floats.

Three host stores speak it: DiskStore (one DiskClusterStore file of
float32 blocks, the paper's on-disk case) and, from
repro_torch.index.sharded, ShardedDiskStore (format-v1 float block
shards; `is_coded=False`, with `cap`, `dim` and float32 decode of
float32, bfloat16 and int8 records) and ShardedPQStore (format-v2 PQ
code shards). The sharded stores mask an updated index's tombstoned
slots at fetch time. Each counts its reads in `stats` (IOStats: one op
per run of adjacent cluster ids) under a lock, so the engine's prefetch
thread can share it with the serving thread.

Two device stores keep the whole corpus on the device (`is_host=False`):
InMemoryStore (float embeddings) and PQStore (PQ codes). Each builds its
cluster-major block table once — (N, cap, dim) float32 with padded slots
0, or (N, cap, nsub) uint8 codes with padded slots coded as doc 0 — so
that `score_blocks(q, sel_ids)` scores a selection with the slot's
cluster id as the block position, through the cluster_score kernel or
the adc_tables + adc_score_blocks kernels, and nothing materialises the
(B, S, cap, dim) gather. They also keep the JAX stores' `score_docs`.
"""

import threading
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import quant as quant_lib
from repro_torch.core.disk import DiskClusterStore, IOStats
from repro_torch.index.builder import _np
from repro_torch.index.sharded import (  # noqa: F401
    ShardedDiskStore, ShardedPQStore,
)
from repro_torch.kernels import adc as adc_ops
from repro_torch.kernels.cluster_score import cluster_score


@runtime_checkable
class ClusterStore(Protocol):
    is_host: bool

    def fetch_blocks(self, cluster_ids):
        """-> (vecs, docs, valid); see module docstring."""
        ...


def _slots(cluster_docs, cluster_ids):
    docs = cluster_docs[torch.as_tensor(cluster_ids).long()]
    return docs, docs >= 0


class InMemoryStore:
    """Device-resident float embeddings and their (N, cap, dim) block
    table (6.4 GB at N 8192, cap 256, dim 768)."""

    is_host = False
    is_coded = False

    def __init__(self, embeddings, cluster_docs):
        if embeddings is None:
            raise ValueError("InMemoryStore needs the index's embeddings")
        self.embeddings = embeddings.float()          # (D, dim)
        self.cluster_docs = cluster_docs              # (N, cap) int32
        docs = cluster_docs.long()
        self.blocks = self.embeddings[docs.clamp(min=0)]
        self.blocks.masked_fill_((docs < 0)[..., None], 0.0)

    @property
    def cap(self):
        return int(self.cluster_docs.shape[1])

    @property
    def dim(self):
        return int(self.embeddings.shape[1])

    def fetch_blocks(self, cluster_ids):
        docs, valid = _slots(self.cluster_docs, cluster_ids)
        return self.blocks[torch.as_tensor(cluster_ids).long()], docs, valid

    def score_docs(self, q_dense, doc_ids):
        """(B, dim) x (B, K) doc ids -> (B, K) exact dot scores."""
        vecs = self.embeddings[doc_ids.long()]
        return torch.einsum("bd,bkd->bk", q_dense.float(), vecs)

    def score_blocks(self, q_dense, sel_ids):
        """(B, dim) queries x (B, S) cluster ids -> (B, S, cap) scores."""
        return cluster_score(q_dense.float().contiguous(), self.blocks,
                             sel_ids.int().contiguous())


class PQStore:
    """Device-resident PQ codes and their (N, cap, nsub) uint8 code block
    table (201 MB at N 8192, cap 256, nsub 96). Scores by ADC lookup
    tables; `fetch_blocks` decodes through the codebooks."""

    is_host = False
    is_coded = True

    def __init__(self, pq, cluster_docs):
        self.pq = pq
        self.cluster_docs = cluster_docs
        docs = cluster_docs.long()
        self.code_blocks = pq.codes.to(torch.uint8)[docs.clamp(min=0)]

    @property
    def codebooks(self):
        return self.pq.codebooks

    @property
    def rotation(self):
        return self.pq.rotation

    @property
    def nsub(self):
        return self.pq.nsub

    @property
    def cap(self):
        return int(self.cluster_docs.shape[1])

    @property
    def dim(self):
        return int(self.pq.nsub * self.pq.codebooks.shape[2])

    def fetch_code_blocks(self, cluster_ids):
        """-> (codes, docs, valid): (..., cap, nsub) uint8, padded slots
        coded as doc 0 and masked by valid."""
        docs, valid = _slots(self.cluster_docs, cluster_ids)
        return (self.code_blocks[torch.as_tensor(cluster_ids).long()], docs,
                valid)

    def fetch_blocks(self, cluster_ids):
        docs, valid = _slots(self.cluster_docs, cluster_ids)
        flat = torch.where(valid, docs, 0).reshape(-1)
        vecs = quant_lib.reconstruct(self.pq, flat)
        vecs = vecs.reshape(docs.shape + (vecs.shape[-1],))
        return torch.where(valid[..., None], vecs, 0.0), docs, valid

    def score_docs(self, q_dense, doc_ids):
        lut = quant_lib.adc_tables(self.pq, q_dense)
        return quant_lib.adc_score(self.pq, lut, doc_ids)

    def score_blocks(self, q_dense, sel_ids):
        """(B, dim) queries x (B, S) cluster ids -> (B, S, cap) ADC
        scores, summed over ascending subspaces."""
        lut = quant_lib.adc_tables(self.pq, q_dense)
        return adc_ops.adc_score_blocks(lut, self.code_blocks,
                                        sel_ids.int().contiguous())


class DiskStore:
    """On-disk cluster blocks (wraps core.disk.DiskClusterStore).

    fetch_blocks takes a 1-D host sequence of cluster ids and reads one
    block per id (a run of adjacent ids in one op), counting I/O ops and
    bytes into `stats` under a lock, so a background prefetcher can share
    the store with the serving thread. Blocks come back as float32 host
    arrays; the engine scores them on its device (kernel cluster_score
    on the card)."""

    is_host = True
    is_coded = False

    def __init__(self, block_store: DiskClusterStore, cluster_docs,
                 stats: IOStats = None):
        self.blocks = block_store
        self.cluster_docs_np = _np(cluster_docs)
        self.cluster_docs = torch.from_numpy(np.array(self.cluster_docs_np))
        self.stats = stats if stats is not None else IOStats()
        self._lock = threading.Lock()

    @classmethod
    def create(cls, path, embeddings, cluster_docs, **kw):
        """Pack `embeddings` into a new block file at `path` and serve it."""
        return cls(DiskClusterStore.pack(path, embeddings, cluster_docs),
                   cluster_docs, **kw)

    @property
    def block_bytes(self):
        return self.blocks.block_bytes

    @property
    def cap(self):
        return self.blocks.cap

    @property
    def dim(self):
        return self.blocks.dim

    def fetch_blocks(self, cluster_ids):
        """-> (vecs (n, cap, dim) float32, docs (n, cap) int32, valid),
        all numpy."""
        cluster_ids = np.asarray(cluster_ids, np.int64).reshape(-1)
        docs = self.cluster_docs_np[cluster_ids]
        if len(cluster_ids) == 0:
            return (np.zeros((0, self.cap, self.dim), np.float32), docs,
                    docs >= 0)
        local = IOStats()
        vecs = self.blocks.fetch_clusters(cluster_ids, local).numpy()
        with self._lock:
            self.stats.add(local.n_ops, local.bytes, local.wall_ms)
        return vecs, docs, docs >= 0


def store_for_index(index):
    """The default device store of a CluSDIndex, on the index's device:
    PQStore if it carries a quantizer, else InMemoryStore over its
    embeddings."""
    if getattr(index, "quantizer", None) is not None:
        return PQStore(index.quantizer, index.cluster_docs)
    return InMemoryStore(index.embeddings, index.cluster_docs)
