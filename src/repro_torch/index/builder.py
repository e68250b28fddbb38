"""The write side of a v2 index that serving needs: even cluster ranges
per shard and the code-shard writer, byte for byte the JAX package's
(`shard_ranges`, `_write_code_blocks`). The manifest, arrays, checkpoint
and the reader wait for a later slice."""

import os

import numpy as np


def shard_ranges(n_clusters, n_shards):
    """Even [lo, hi) cluster ranges; first shards absorb the remainder."""
    n_shards = max(1, min(n_shards, n_clusters))
    base, rem = divmod(n_clusters, n_shards)
    ranges, lo = [], 0
    for s in range(n_shards):
        hi = lo + base + (1 if s < rem else 0)
        ranges.append((lo, hi))
        lo = hi
    return ranges


def write_code_blocks(path, codes, cluster_docs):
    """One shard's (n, cap, nsub) uint8 code blocks; padded slots code 0
    (masked by cluster_docs at read time). codes: (D, nsub) int codes in
    [0, 255], cast to uint8 here."""
    codes = np.asarray(codes)
    if codes.size and (codes.min() < 0 or codes.max() > 255):
        raise ValueError("PQ codes out of uint8 range")
    cd = np.asarray(cluster_docs)
    block = np.zeros(cd.shape + (codes.shape[1],), np.uint8)
    mask = cd >= 0
    block[mask] = codes[cd[mask]].astype(np.uint8)
    block.tofile(path)


def write_code_shards(out_dir, codes, cluster_docs, n_shards):
    """Write `blocks/shard_{s:05d}.codes.bin` under out_dir for every even
    cluster range. Returns (paths, ranges) for ShardedPQStore."""
    os.makedirs(os.path.join(out_dir, "blocks"), exist_ok=True)
    codes = np.asarray(codes)
    cd = np.asarray(cluster_docs)
    ranges = shard_ranges(cd.shape[0], n_shards)
    paths = []
    for s, (lo, hi) in enumerate(ranges):
        path = os.path.join(out_dir, "blocks", f"shard_{s:05d}.codes.bin")
        write_code_blocks(path, codes, cd[lo:hi])
        paths.append(path)
    return paths, ranges
