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
and no allocation. Finished traces land in a bounded deque (`capacity`,
oldest dropped and counted) and export as:

  * JSONL — one span per line:
      {"trace": 3, "trace_name": "batch", "span": "stage1", "index": 1,
       "parent": 0, "depth": 1, "t0_ms": 0.01, "dur_ms": 1.2, ...annot}
  * Chrome trace JSON ({"traceEvents": [...]}, "X" complete events,
    microsecond timestamps) — open in chrome://tracing or Perfetto.

A copy of the JAX package's `repro.obs.trace`: a tracer holding the same
spans exports the same JSONL records and Chrome events.
"""

import json
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

    def end(self):
        """Close without a `with` block (phases that straddle scopes)."""
        self._trace._close(self)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._trace._close(self)
        return False

    def to_dict(self, trace_id, trace_name):
        d = {"trace": trace_id, "trace_name": trace_name,
             "span": self.name, "index": self.index, "parent": self.parent,
             "depth": self.depth, "t0_ms": round(self.t0_ms, 3),
             "dur_ms": round(self.dur_ms or 0.0, 3)}
        d.update(self.annot)
        return d


class _NoopSpan:
    """Shared do-nothing span: the tracing-disabled hot path."""

    __slots__ = ()

    def annotate(self, **kw):
        return self

    def end(self):
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

    def add_completed(self, name, *, t0_abs, dur_ms, parent=None, **annot):
        return NOOP_SPAN

    def annotate(self, **kw):
        return self

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

    def add_completed(self, name, *, t0_abs, dur_ms, parent=None, **annot):
        """Graft an already-measured span under an explicit parent.

        For work timed on another thread with the same perf_counter
        clock (e.g. EngineHost workers in-process): `t0_abs` is the raw
        `time.perf_counter()` at span start, `dur_ms` its duration, and
        `parent` a Span of this trace (default: innermost open span).
        The span is appended CLOSED and never touches the nesting stack,
        so the calling thread's own span structure is unaffected."""
        if parent is None:
            parent = self._stack[-1] if self._stack else self.spans[0]
        sp = Span(self, name, len(self.spans), parent.index,
                  parent.depth + 1, (t0_abs - self._t0) * 1e3, annot)
        sp.dur_ms = float(dur_ms)
        self.spans.append(sp)
        return sp

    def _close(self, sp):
        if sp.dur_ms is None:
            sp.dur_ms = self._now_ms() - sp.t0_ms
        if self._stack and self._stack[-1] is sp:
            self._stack.pop()

    def annotate(self, **kw):
        """Annotate the innermost open span (the root before any child)."""
        (self._stack[-1] if self._stack else self.spans[0]).annot.update(kw)
        return self

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

    def to_dicts(self):
        return [sp.to_dict(self.trace_id, self.name) for sp in self.spans]


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

    @property
    def enabled(self):
        return self.sample_rate > 0.0

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

    def clear(self):
        with self._lock:
            self._traces.clear()

    def span_totals(self, trace_name=None, skip_root=True):
        """{span name: {"ms": total, "count": n}} across retained traces
        (optionally only traces named `trace_name`; the root span — which
        spans the whole trace — is excluded unless skip_root=False)."""
        out = {}
        for tr in self.traces:
            if trace_name is not None and tr.name != trace_name:
                continue
            for sp in tr.spans:
                if skip_root and sp.index == 0:
                    continue
                agg = out.setdefault(sp.name, {"ms": 0.0, "count": 0})
                agg["ms"] += sp.dur_ms or 0.0
                agg["count"] += 1
        for agg in out.values():
            agg["ms"] = round(agg["ms"], 3)
        return out

    def export_jsonl(self, path):
        """One span per line (schema in the module docstring)."""
        with open(path, "w") as f:
            for tr in self.traces:
                for d in tr.to_dicts():
                    f.write(json.dumps(d) + "\n")
        return path

    def export_chrome(self, path):
        """Chrome trace JSON: open in chrome://tracing or Perfetto."""
        events = []
        for tr in self.traces:
            for sp in tr.spans:
                # host-attributed spans (cross-host graft) get their own
                # per-host lane so scatter fan-out reads as parallel work
                tid = tr.trace_id
                if "host" in sp.annot:
                    tid = f"{tr.trace_id}.host{sp.annot['host']}"
                events.append({
                    "name": sp.name, "cat": tr.name, "ph": "X",
                    "ts": round((tr.t0_rel_ms + sp.t0_ms) * 1e3, 1),
                    "dur": round((sp.dur_ms or 0.0) * 1e3, 1),
                    "pid": 0, "tid": tid,
                    "args": {k: v for k, v in sp.annot.items()},
                })
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return path


def write_trace(tracer, path):
    """Export retained traces, format by suffix: .jsonl -> JSONL span
    lines, anything else -> Chrome trace JSON."""
    p = str(path)
    if p.endswith(".jsonl"):
        return tracer.export_jsonl(p)
    return tracer.export_chrome(p)
