"""Index storage: the offline build, the versioned on-disk format (v1
float blocks, v2 PQ code shards), the writer, the sharded block stores,
the reader, and incremental updates (upsert/delete deltas, tombstones,
atomic generations, compaction) — the JAX package's `repro.index` API."""

from repro_torch.index.builder import (
    RowSlice, build_index_offline, embedding_shards, postings_csr,
    postings_from_csr, shard_ranges, write_index)
from repro_torch.index.format import (
    FORMAT_VERSION, FORMAT_VERSION_PQ, SUPPORTED_VERSIONS,
    IndexChecksumError, IndexFormatError, file_sha256, load_manifest,
    manifest_generation, verify_files)
from repro_torch.index.reader import IndexReader
from repro_torch.index.sharded import ShardedDiskStore, ShardedPQStore
from repro_torch.index.update import (
    IndexDelta, apply_delta_to_index, compact_index, write_index_delta)

__all__ = [
    "FORMAT_VERSION", "FORMAT_VERSION_PQ", "IndexChecksumError",
    "IndexDelta", "IndexFormatError", "IndexReader", "RowSlice",
    "SUPPORTED_VERSIONS", "ShardedDiskStore", "ShardedPQStore",
    "apply_delta_to_index", "build_index_offline", "compact_index",
    "embedding_shards", "file_sha256", "load_manifest",
    "manifest_generation", "postings_csr", "postings_from_csr",
    "shard_ranges", "verify_files", "write_index", "write_index_delta",
]
