"""Cluster-block I/O accounting and run-coalesced block reads (a copy of
the JAX package's `IOStats` and `read_blocks_coalesced`).

IOStats' latency model uses the paper's constants (0.15 ms per I/O op on
their PCIe SSD, plus a 3 GB/s bandwidth term); `wall_ms` is measured.
"""

import dataclasses

import numpy as np

PER_OP_MS = 0.15          # paper: per-I/O-op queueing/software overhead
SSD_BW_GBPS = 3.0         # PCIe SSD sequential bandwidth


@dataclasses.dataclass
class IOStats:
    n_ops: int = 0
    bytes: int = 0
    wall_ms: float = 0.0

    def model_ms(self):
        return self.n_ops * PER_OP_MS + self.bytes / (SSD_BW_GBPS * 1e6)

    def add(self, ops, nbytes, wall):
        self.n_ops += ops
        self.bytes += nbytes
        self.wall_ms += wall


def read_blocks_coalesced(mm, ids, out=None, out_offset=0):
    """Copy blocks `mm[ids]` into `out`, coalescing runs of adjacent ids
    into single contiguous memmap reads. Returns (out, n_runs) — one I/O
    op per run, not per block."""
    ids = np.asarray(ids, np.int64)
    n = len(ids)
    if out is None:
        out = np.empty((n,) + mm.shape[1:], mm.dtype)
    if n == 0:
        return out, 0
    brk = np.flatnonzero(np.diff(ids) != 1) + 1
    bounds = np.concatenate([[0], brk, [n]])
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        out[out_offset + lo:out_offset + hi] = mm[ids[lo]:ids[lo] + (hi - lo)]
    return out, len(bounds) - 1
