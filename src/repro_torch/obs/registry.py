"""Low-overhead metrics registry: counters, gauges, bounded histograms.

Design constraints (this sits on the serving hot path):

  * every mutation is one lock acquire + one or two float adds — no
    allocation, no string formatting;
  * memory is bounded: a Histogram keeps fixed bucket counts plus a ring
    of the most recent `ring` raw observations (for exact percentiles
    over the recent window); counters and gauges are single cells;
  * thread-safe: the serving thread, the prefetch worker, and a control
    thread calling snapshot()/reset() may all touch one registry.

Metric names use dotted paths ("serve.batch_ms"), as in the JAX
package's registry, of which this module is the part the engine uses
(snapshots and the Prometheus and file exporters wait).
"""

import collections
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
    lifetime; the ring keeps the most recent `ring` observations (a
    deque(maxlen=ring), so memory never grows past the window)."""

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

    def reset(self):
        with self._lock:
            self.bucket_counts = [0] * len(self.buckets)
            self.count = 0
            self.sum = 0.0
            self._ring.clear()

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
