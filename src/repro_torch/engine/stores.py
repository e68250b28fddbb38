"""Cluster-block storage backends behind one protocol.

  fetch_blocks(cluster_ids) -> (vecs, docs, valid)
    cluster_ids : 1-D host sequence of cluster ids
    vecs  : (n, cap, dim) float32 block embeddings
    docs  : (n, cap)      int32 doc ids, -1 pad
    valid : (n, cap)      bool  (docs >= 0)

Host backends (`is_host`) read from disk; the pipeline batches selection
on the device and fetches deduplicated blocks on the host. A code-backed
backend (`is_coded`) also answers `fetch_code_blocks(cluster_ids) ->
(codes, docs, valid)` with RAW (n, cap, nsub) uint8 code blocks and
exposes `codebooks`/`rotation`/`nsub`, so the pipeline scores codes via
ADC lookup tables without decoding floats.

Two host stores speak it, both from repro_torch.index.sharded:
ShardedDiskStore (format-v1 float block shards; `is_coded=False`, with
`cap`, `dim` and float32 decode of float32, bfloat16 and int8 records)
and ShardedPQStore (format-v2 PQ code shards). Both mask an updated
index's tombstoned slots at fetch time. The JAX package's device stores
(InMemoryStore, PQStore) are not ported.
"""

from typing import Protocol, runtime_checkable

from repro_torch.index.sharded import (  # noqa: F401
    ShardedDiskStore, ShardedPQStore,
)


@runtime_checkable
class ClusterStore(Protocol):
    is_host: bool

    def fetch_blocks(self, cluster_ids):
        """-> (vecs, docs, valid); see module docstring."""
        ...
