"""Stage-span tracing: nested wall-clock spans per request/batch.

A `Trace` is one request's (or one build/reload's) tree of named spans:

    tr = tracer.trace("batch", size=32)       # opens the root span
    with tr.span("stage1"):
        ...
    with tr.span("cache_fetch", n_blocks=17) as sp:
        with tr.span("disk_fetch"):           # nests under cache_fetch
            ...
        sp.annotate(bytes=blocks.nbytes)
    tr.finish(compiled=False)                 # closes the root span

Spans record start offset + duration (time.perf_counter), nesting depth,
parent index, and free-form annotations (byte/op counts).

`Tracer` owns sampling and retention: `sample_rate` in [0, 1] decides
(deterministically, via an accumulator — no RNG) which traces are
recorded; unsampled requests get the shared NOOP_TRACE whose span() is a
reusable no-op context manager, so the disabled path costs one float add
and no allocation. Finished traces land in a bounded list (`capacity`,
oldest dropped and counted).

The part of the JAX package's tracer that the engine uses; span totals
and the JSONL and Chrome-trace exporters wait for a later slice.
"""

import threading
import time


class Span:
    """One timed region. Context manager; closes itself on __exit__."""

    __slots__ = ("name", "index", "parent", "depth", "t0_ms", "dur_ms",
                 "annot", "_trace")

    def __init__(self, trace, name, index, parent, depth, t0_ms, annot):
        self._trace = trace
        self.name = name
        self.index = index
        self.parent = parent
        self.depth = depth
        self.t0_ms = t0_ms
        self.dur_ms = None          # open until __exit__/end()
        self.annot = annot

    def annotate(self, **kw):
        self.annot.update(kw)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._trace._close(self)
        return False

class _NoopSpan:
    """Shared do-nothing span: the tracing-disabled hot path."""

    __slots__ = ()

    def annotate(self, **kw):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _NoopTrace:
    """Shared do-nothing trace returned for unsampled requests."""

    __slots__ = ()
    spans = ()

    def span(self, name, **annot):
        return NOOP_SPAN

    def finish(self, **annot):
        return self


NOOP_SPAN = _NoopSpan()
NOOP_TRACE = _NoopTrace()


class Trace:
    """A tree of spans for one request/batch. Single-threaded by design:
    spans nest via a stack owned by the thread driving the request."""

    def __init__(self, tracer, trace_id, name, t0_rel_ms, annot):
        self._tracer = tracer
        self.trace_id = trace_id
        self.name = name
        self.t0_rel_ms = t0_rel_ms      # offset from tracer epoch
        self._t0 = time.perf_counter()
        self.spans = []
        self._stack = []
        # span 0 is the implicit root covering the whole trace
        root = Span(self, name, 0, -1, 0, 0.0, dict(annot))
        self.spans.append(root)
        self._stack.append(root)

    def _now_ms(self):
        return (time.perf_counter() - self._t0) * 1e3

    def span(self, name, **annot):
        """Open a child span of the innermost open span."""
        parent = self._stack[-1] if self._stack else self.spans[0]
        sp = Span(self, name, len(self.spans), parent.index,
                  parent.depth + 1, self._now_ms(), annot)
        self.spans.append(sp)
        self._stack.append(sp)
        return sp

    def _close(self, sp):
        if sp.dur_ms is None:
            sp.dur_ms = self._now_ms() - sp.t0_ms
        if self._stack and self._stack[-1] is sp:
            self._stack.pop()

    def finish(self, **annot):
        """Close any open spans (root last) and hand the trace to the
        tracer's bounded retention."""
        while self._stack:
            self._close(self._stack[-1])
        self.spans[0].annot.update(annot)
        self._tracer._retain(self)
        return self

    @property
    def dur_ms(self):
        return self.spans[0].dur_ms

class Tracer:
    """Sampling + bounded retention + exporters. Thread-safe at the
    trace granularity (each Trace itself is single-threaded)."""

    def __init__(self, sample_rate=0.0, capacity=1024):
        self.sample_rate = float(sample_rate)
        self.capacity = int(capacity)
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._traces = []           # finished, bounded by capacity
        self._acc = 0.0             # deterministic sampling accumulator
        self._next_id = 0
        self.started = 0            # sampled traces opened
        self.skipped = 0            # unsampled requests (NOOP handed out)
        self.dropped = 0            # finished traces evicted by capacity

    def trace(self, name, **annot):
        """A sampled Trace, or the shared NOOP_TRACE. Deterministic: a
        rate of 0.25 records exactly every 4th request."""
        with self._lock:
            self._acc += self.sample_rate
            if self._acc < 1.0:
                self.skipped += 1
                return NOOP_TRACE
            self._acc -= 1.0
            tid = self._next_id
            self._next_id += 1
            self.started += 1
        return Trace(self, tid, name,
                     (time.perf_counter() - self._epoch) * 1e3, annot)

    def _retain(self, trace):
        with self._lock:
            self._traces.append(trace)
            while len(self._traces) > self.capacity:
                self._traces.pop(0)
                self.dropped += 1

    @property
    def traces(self):
        with self._lock:
            return list(self._traces)
