"""Serving: the select/score/fuse stages over a host store, and the
RetrievalEngine front-end (bucketed batching, LRU block cache, async
prefetch, ADC scoring of raw PQ codes)."""

from repro_torch.engine.cache import BlockCache
from repro_torch.engine.pipeline import (build_fused_scorer, dedup_selected,
                                         fetch_unique_code_blocks)
from repro_torch.engine.server import RetrievalEngine, ServeStats, bucket_size
from repro_torch.engine.stores import ClusterStore, ShardedPQStore

__all__ = ["BlockCache", "ClusterStore", "RetrievalEngine", "ServeStats",
           "ShardedPQStore", "bucket_size", "build_fused_scorer",
           "dedup_selected", "fetch_unique_code_blocks"]
