"""Index storage: the versioned on-disk format, the writer, the sharded
block stores and the reader."""

from repro_torch.index.builder import (postings_from_csr, shard_ranges,
                                       write_index)
from repro_torch.index.format import (FORMAT_VERSION, FORMAT_VERSION_PQ,
                                      SUPPORTED_VERSIONS, IndexChecksumError,
                                      IndexFormatError, load_manifest,
                                      verify_files)
from repro_torch.index.reader import IndexReader
from repro_torch.index.sharded import ShardedDiskStore, ShardedPQStore

__all__ = ["FORMAT_VERSION", "FORMAT_VERSION_PQ", "IndexChecksumError",
           "IndexFormatError", "IndexReader", "SUPPORTED_VERSIONS",
           "ShardedDiskStore", "ShardedPQStore", "load_manifest",
           "postings_from_csr", "shard_ranges", "verify_files",
           "write_index"]
