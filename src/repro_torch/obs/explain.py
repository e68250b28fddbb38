"""Per-query explain telemetry: sampled JSONL records of why each query
retrieved what it did (a copy of the JAX package's `repro.obs.explain`).

`ExplainLogger` is transport only: sampling, serialization, bounded
in-memory retention. Record construction lives in
`engine/server.py::build_explain_records`.

Sampling is a deterministic accumulator, so rate 0.25 explains exactly
every 4th batch, starting with the first.

Each record is one JSON object per line; the load-bearing fields:

  qid          global query index (engine serve-stats order)
  generation   index generation that served the query
  cand         stage-1 candidate cluster ids (seed + graph expansion)
  provenance   per-candidate "seed" | "expand" (seed = rank < n_candidates)
  probs        selector probability per candidate (rounded)
  selected     cluster ids the selector kept (theta + budget)
  n_over_theta / skipped_over_theta   budget-cutoff visibility
  fusion_contrib  final-top-k membership: sparse_only/dense_only/both

Disabled path: `engine.explain is None`, one attribute check per batch.
"""

import json
import threading


class ExplainLogger:
    """Sampled JSONL sink for explain records.

    Args:
        path: output JSONL file (opened lazily on first emit); None keeps
            records only in the in-memory ring (tests).
        sample_rate: fraction of batches to explain, in [0, 1].
            Deterministic accumulator — rate r explains every ~1/r-th
            batch exactly, starting with the first.
        capacity: in-memory ring size (most recent records kept).
    """

    def __init__(self, path=None, *, sample_rate=1.0, capacity=512):
        if not (0.0 <= sample_rate <= 1.0):
            raise ValueError(f"sample_rate {sample_rate} not in [0, 1]")
        self.path = path
        self.sample_rate = float(sample_rate)
        self.capacity = int(capacity)
        self._acc = 1.0          # first batch sampled when rate > 0
        self._lock = threading.Lock()
        self._fh = None
        self._ring = []
        self.n_sampled = 0
        self.n_skipped = 0
        self.n_records = 0

    def sample(self):
        """Decide whether to explain the next batch. Deterministic: an
        accumulator gains `sample_rate` per call and a batch is sampled
        each time it crosses 1."""
        with self._lock:
            if self.sample_rate <= 0.0:
                self.n_skipped += 1
                return False
            self._acc += self.sample_rate
            if self._acc >= 1.0:
                self._acc -= 1.0
                self.n_sampled += 1
                return True
            self.n_skipped += 1
            return False

    def emit(self, record):
        """Write one explain record (a JSON-serializable dict)."""
        line = json.dumps(record, separators=(",", ":"))
        with self._lock:
            self._ring.append(record)
            if len(self._ring) > self.capacity:
                del self._ring[:len(self._ring) - self.capacity]
            self.n_records += 1
            if self.path is not None:
                if self._fh is None:
                    self._fh = open(self.path, "w")
                self._fh.write(line + "\n")

    def recent(self):
        """Most recent records (bounded by `capacity`), oldest first."""
        with self._lock:
            return list(self._ring)

    def flush(self):
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def stats(self):
        with self._lock:
            return {"n_sampled": self.n_sampled,
                    "n_skipped": self.n_skipped,
                    "n_records": self.n_records,
                    "sample_rate": self.sample_rate,
                    "path": self.path}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
