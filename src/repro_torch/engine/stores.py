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

This slice serves the v2 code-shard store, ShardedPQStore
(repro_torch.index.sharded); the float-block and device stores wait.
"""

from typing import Protocol, runtime_checkable

from repro_torch.index.sharded import ShardedPQStore  # noqa: F401


@runtime_checkable
class ClusterStore(Protocol):
    is_host: bool

    def fetch_blocks(self, cluster_ids):
        """-> (vecs, docs, valid); see module docstring."""
        ...
