"""Bounded LRU cache of hot cluster blocks, keyed by cluster id (the JAX
engine's BlockCache). `RetrievalEngine.reload_index` replaces it on a
generation swap and carries its counters; `clears` counts the swaps.

Thread-safe: the serving thread and the background prefetcher share one
instance. Tracks hit/miss/eviction counts for `stats()`.

The bound is a byte budget (`capacity_bytes`) on the ACTUAL bytes stored
(`block.nbytes`), so what fits depends on what is cached: a PQ code
block (cap x nsub uint8) is 4*dim/nsub times smaller than its float
block. The engine sizes the budget in float32-block equivalents, so a
float store caches `cache_capacity` blocks and a code-backed store that
many more clusters. `cached_bytes` in stats() reports the live total;
`capacity` stays in stats() as None for key parity with the JAX engine,
whose entry-count mode served stores of unknown geometry.
"""

import collections
import threading


class BlockCache:
    def __init__(self, capacity_bytes):
        if capacity_bytes < 1:
            raise ValueError(
                f"capacity_bytes must be >= 1, got {capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self._blocks = collections.OrderedDict()   # cid -> block array
        self._lock = threading.Lock()
        self._fetch_lock = threading.Lock()        # single-flight miss fills
        self.cached_bytes = 0    # actual stored bytes (sum of block.nbytes)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.clears = 0      # full invalidations (index generation swaps)

    def __len__(self):
        with self._lock:
            return len(self._blocks)

    def __contains__(self, cid):
        with self._lock:
            return cid in self._blocks

    def get(self, cid):
        """Block for `cid` (refreshing recency) or None on miss."""
        with self._lock:
            blk = self._blocks.get(cid)
            if blk is None:
                self.misses += 1
                return None
            self._blocks.move_to_end(cid)
            self.hits += 1
            return blk

    def _peek(self, cid):
        """Like get() but without hit/miss accounting (internal re-checks
        and prefetch probes must not skew serving-path stats)."""
        with self._lock:
            blk = self._blocks.get(cid)
            if blk is not None:
                self._blocks.move_to_end(cid)
            return blk

    def get_or_fetch_many(self, cids, fetch_fn, record=True):
        """{cid: block} for every cid; misses are filled via
        `fetch_fn(list_of_cids) -> (n, ...) array` under a
        single-flight lock, so a concurrent prefetcher and the serving
        thread never read the same cold block twice. `record=False`
        skips hit/miss accounting (prefetch path)."""
        out, misses, pending = {}, [], set()
        for c in cids:
            c = int(c)
            if c in out or c in pending:
                continue
            blk = self.get(c) if record else self._peek(c)
            if blk is None:
                misses.append(c)
                pending.add(c)
            else:
                out[c] = blk
        if misses:
            with self._fetch_lock:
                # another thread may have filled some while we waited
                need = []
                for c in misses:
                    blk = self._peek(c)
                    if blk is None:
                        need.append(c)
                    else:
                        out[c] = blk
                if need:
                    vecs = fetch_fn(need)
                    for i, c in enumerate(need):
                        # copy: caching a view of the batch-fetch array
                        # would pin the whole buffer past eviction
                        out[c] = vecs[i].copy()
                        self.put(c, out[c])
        return out

    @staticmethod
    def _nbytes(block):
        return int(getattr(block, "nbytes", 0))

    def put(self, cid, block):
        with self._lock:
            old = self._blocks.pop(cid, None)    # re-insert at most-recent end
            if old is not None:
                self.cached_bytes -= self._nbytes(old)
            self._blocks[cid] = block
            self.cached_bytes += self._nbytes(block)
            while self.cached_bytes > self.capacity_bytes \
                    and len(self._blocks) > 1:
                _, evicted = self._blocks.popitem(last=False)
                self.cached_bytes -= self._nbytes(evicted)
                self.evictions += 1

    def hit_rate(self):
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def stats(self):
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "clears": self.clears,
                "size": len(self), "cached_bytes": self.cached_bytes,
                "capacity": None,
                "capacity_bytes": self.capacity_bytes,
                "hit_rate": round(self.hit_rate(), 4)}
