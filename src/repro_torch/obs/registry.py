"""Low-overhead metrics registry: counters, gauges, bounded histograms.

Design constraints (this sits on the serving hot path):

  * every mutation is one lock acquire + one or two float adds — no
    allocation, no string formatting;
  * memory is bounded: a Histogram keeps fixed bucket counts plus a ring
    of the most recent `ring` raw observations (for exact percentiles
    over the recent window); counters and gauges are single cells;
  * thread-safe: the serving thread, the prefetch worker, and a control
    thread calling snapshot()/reset() may all touch one registry.

Snapshots come in two shapes: `snapshot()` returns a plain nested dict
(JSON-ready), `to_prometheus()` returns text exposition (counter/gauge/
histogram with cumulative `_bucket{le=...}` lines) so a scrape endpoint
or a file drop can feed standard dashboards. Metric names use dotted
paths ("serve.batch_ms"); the Prometheus view rewrites them to
underscores. A copy of the JAX package's `repro.obs.registry`: a registry
holding the same values gives the same snapshot and the same text.
"""

import collections
import json
import math
import threading

# Upper bounds (ms) for latency histograms: sub-ms resolution where the
# fused serving tail lives, decade coverage up to multi-second builds.
DEFAULT_MS_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                      250.0, 500.0, 1000.0, 2500.0, 5000.0, math.inf)
DEFAULT_RING = 8192


class Counter:
    """Monotonic accumulator (int or float increments)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self.value += n

    def reset(self):
        with self._lock:
            self.value = 0


class Gauge:
    """Last-write-wins sampled value."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self.value = v

    def reset(self):
        with self._lock:
            self.value = 0.0


class Histogram:
    """Fixed-bucket histogram + bounded ring of recent raw observations.

    The bucket counts and count/sum are exact over the histogram's whole
    lifetime; `values()`/`percentile()` are exact over the most recent
    `ring` observations (a deque(maxlen=ring), so memory never grows past
    the window — the fix for the unbounded ServeStats batch list)."""

    __slots__ = ("name", "buckets", "bucket_counts", "count", "sum",
                 "_ring", "_lock")

    def __init__(self, name, buckets=DEFAULT_MS_BUCKETS, ring=DEFAULT_RING):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds or bounds[-1] != math.inf:
            bounds = bounds + (math.inf,)
        self.name = name
        self.buckets = bounds
        self.bucket_counts = [0] * len(bounds)
        self.count = 0
        self.sum = 0.0
        self._ring = collections.deque(maxlen=int(ring))
        self._lock = threading.Lock()

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    self.bucket_counts[i] += 1
                    break
            self._ring.append(v)

    def values(self):
        """Most recent observations, oldest first (bounded by `ring`)."""
        with self._lock:
            return list(self._ring)

    def percentile(self, q):
        """Exact percentile over the recent window; None when empty."""
        vals = sorted(self.values())
        if not vals:
            return None
        if len(vals) == 1:
            return vals[0]
        # linear interpolation, matching np.percentile's default
        rank = (q / 100.0) * (len(vals) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(vals) - 1)
        return vals[lo] + (vals[hi] - vals[lo]) * (rank - lo)

    def mean(self):
        vals = self.values()
        return sum(vals) / len(vals) if vals else None

    def reset(self):
        with self._lock:
            self.bucket_counts = [0] * len(self.buckets)
            self.count = 0
            self.sum = 0.0
            self._ring.clear()

    def snapshot(self):
        with self._lock:
            counts = list(self.bucket_counts)
            count, total = self.count, self.sum
            vals = sorted(self._ring)
        out = {"count": count, "sum": round(total, 3),
               # string keys (JSON-safe, sortable): {"0.5": n, ..., "+Inf": n}
               "buckets": {("+Inf" if ub == math.inf else repr(ub)): c
                           for ub, c in zip(self.buckets, counts)}}
        if vals:
            def pct(q):
                rank = (q / 100.0) * (len(vals) - 1)
                lo = int(math.floor(rank))
                hi = min(lo + 1, len(vals) - 1)
                return round(vals[lo] + (vals[hi] - vals[lo]) * (rank - lo), 3)
            out.update(p50=pct(50), p99=pct(99),
                       mean=round(sum(vals) / len(vals), 3))
        return out


class MetricsRegistry:
    """Get-or-create registry of named metrics; one per process/engine.

    `counter`/`gauge`/`histogram` return the existing metric when the
    name is already registered (and raise if it is registered as a
    different kind — one name, one meaning)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}          # name -> metric (insertion-ordered)

    def _get(self, name, kind, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name):
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name):
        return self._get(name, Gauge, lambda: Gauge(name))

    def histogram(self, name, buckets=DEFAULT_MS_BUCKETS, ring=DEFAULT_RING):
        return self._get(name, Histogram,
                         lambda: Histogram(name, buckets, ring))

    def _items(self):
        with self._lock:
            return list(self._metrics.items())

    def reset(self):
        """Zero every registered metric (keeps registrations)."""
        for _, m in self._items():
            m.reset()

    def snapshot(self):
        """Plain nested dict: {counters:{}, gauges:{}, histograms:{}}."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in self._items():
            if isinstance(m, Counter):
                v = m.value
                out["counters"][name] = round(v, 3) \
                    if isinstance(v, float) else v
            elif isinstance(m, Gauge):
                v = m.value
                out["gauges"][name] = round(v, 4) \
                    if isinstance(v, float) else v
            else:
                out["histograms"][name] = m.snapshot()
        return out

    @staticmethod
    def _prom_name(name):
        return "".join(c if (c.isalnum() or c == "_") else "_"
                       for c in name)

    def to_prometheus(self):
        """Prometheus text exposition (counters, gauges, cumulative
        histogram buckets + _count/_sum)."""
        lines = []
        for name, m in self._items():
            pn = self._prom_name(name)
            if isinstance(m, Counter):
                lines += [f"# TYPE {pn} counter", f"{pn} {m.value}"]
            elif isinstance(m, Gauge):
                lines += [f"# TYPE {pn} gauge", f"{pn} {m.value}"]
            else:
                lines.append(f"# TYPE {pn} histogram")
                cum = 0
                with m._lock:
                    counts = list(m.bucket_counts)
                    count, total = m.count, m.sum
                for ub, c in zip(m.buckets, counts):
                    cum += c
                    le = "+Inf" if ub == math.inf else repr(ub)
                    lines.append(f'{pn}_bucket{{le="{le}"}} {cum}')
                lines += [f"{pn}_sum {total}", f"{pn}_count {count}"]
        return "\n".join(lines) + "\n"

    def write_json(self, path):
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
            f.write("\n")

    def write_prometheus(self, path):
        with open(path, "w") as f:
            f.write(self.to_prometheus())


def write_metrics(registry, path):
    """Write a snapshot, format by suffix: .prom/.txt -> Prometheus text
    exposition, anything else -> JSON."""
    p = str(path)
    if p.endswith((".prom", ".txt")):
        registry.write_prometheus(p)
    else:
        registry.write_json(p)
    return p
