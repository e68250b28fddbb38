"""Serving: the select/score/fuse pipeline over a device store
(InMemoryStore, PQStore) or a host store (DiskStore, the sharded
stores), the RetrievalEngine front-end (bucketed batching, LRU block
cache, async prefetch, ADC scoring of raw PQ codes, "dot" scoring of
float blocks, hot index and selector reloads, explain records), and the
ShardRouter scatter-gather tier over EngineHosts (failover, degraded
mode, rolling generation hops)."""

from repro_torch.engine.cache import BlockCache
from repro_torch.engine.pipeline import (build_fused_scorer, dedup_selected,
                                         fetch_unique_blocks,
                                         fetch_unique_code_blocks)
from repro_torch.engine.server import (RetrievalEngine, ServeStats,
                                       bucket_size, build_explain_records)
from repro_torch.engine.stores import (ClusterStore, DiskStore,
                                       InMemoryStore, PQStore,
                                       ShardedDiskStore, ShardedPQStore,
                                       store_for_index)
from repro_torch.engine.router import (MERGE_SENTINEL, EngineHost, HostDown,
                                       HostRequest, HostResponse,
                                       ShardPlacement, ShardRouter,
                                       merge_partial_topk)

__all__ = ["BlockCache", "ClusterStore", "DiskStore", "EngineHost",
           "HostDown", "HostRequest", "HostResponse", "InMemoryStore",
           "MERGE_SENTINEL", "PQStore", "RetrievalEngine", "ServeStats",
           "ShardPlacement", "ShardRouter", "ShardedDiskStore",
           "ShardedPQStore", "bucket_size", "build_explain_records",
           "build_fused_scorer", "dedup_selected", "fetch_unique_blocks",
           "fetch_unique_code_blocks", "merge_partial_topk",
           "store_for_index"]
