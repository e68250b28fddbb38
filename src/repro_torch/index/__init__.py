"""Index storage: the v2 code-shard writer and the sharded PQ store."""

from repro_torch.index.builder import (shard_ranges, write_code_blocks,
                                       write_code_shards)
from repro_torch.index.sharded import ShardedPQStore

__all__ = ["ShardedPQStore", "shard_ranges", "write_code_blocks",
           "write_code_shards"]
