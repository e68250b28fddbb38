"""Declarative SLO evaluation over a MetricsRegistry: burn rates,
multi-window alerting, and an OK/WARN/PAGE state machine.

An `SLOObjective` names a metric in the registry and a threshold; an
`SLOMonitor` samples `registry.snapshot()` on every `evaluate()` call,
keeps a bounded time series per objective, and reduces each objective to
a *burn rate* — how fast the error budget is being consumed, where 1.0
means "exactly at the objective" — over TWO rolling windows (SRE-style
multi-window alerting):

  * the FAST window (default 60 s) reacts quickly but is noisy;
  * the SLOW window (default 300 s) confirms the burn is sustained.

An objective pages only when BOTH windows burn past `page_burn` (and
warns when both pass `warn_burn`), so a single slow batch cannot page
and a sustained regression cannot hide behind an old quiet period.

Objective kinds (all read the plain `snapshot()` dict, so any registry-
shaped object works and nothing here imports the engine):

  * "latency"    — histogram `metric`; the sampled value is the recent-
                   window p99 (the histogram ring); burn = p99/threshold.
  * "error_rate" — counter `metric` (errors) over counter `total`
                   (requests); the windowed value is delta(errors)/
                   delta(total); burn = rate/threshold. A threshold of 0
                   means zero tolerance: any windowed error pages.
  * "gauge"      — gauge `metric`; burn = abs(value)/threshold (used for
                   recall-proxy drift, where the gauge carries the drift).

State transitions append to a bounded event log (`deque(maxlen=...)`):
{"t", "objective", "from", "to", "value", "burn_fast", "burn_slow"}.

The clock is injectable (`clock=` a monotonic-seconds callable), so every
transition above is unit-testable deterministically; serving code uses
the default `time.monotonic`.

Dependency-free (stdlib only) like the rest of repro_torch.obs: a copy
of the JAX package's `repro.obs.slo`, so the same objectives over the
same registry snapshots give the same burns, states and events.
"""

import collections
import dataclasses
import json
import math
import time

OK, WARN, PAGE = "OK", "WARN", "PAGE"
_SEVERITY = {OK: 0, WARN: 1, PAGE: 2}


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """One declarative objective. `threshold` is the objective itself
    (ms for "latency", error fraction for "error_rate", absolute value
    for "gauge"); burn = measured/threshold, 1.0 = exactly on budget."""

    name: str
    kind: str                    # "latency" | "error_rate" | "gauge"
    metric: str                  # histogram / counter / gauge name
    threshold: float
    total: str = ""              # denominator counter ("error_rate" only)
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    warn_burn: float = 1.0
    page_burn: float = 2.0

    def __post_init__(self):
        if self.kind not in ("latency", "error_rate", "gauge"):
            raise ValueError(f"unknown objective kind {self.kind!r}")
        if self.kind == "error_rate" and not self.total:
            raise ValueError(f"error_rate objective {self.name!r} needs a "
                             f"`total` counter")
        if self.threshold < 0:
            raise ValueError(f"negative threshold on {self.name!r}")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError(f"fast window > slow window on {self.name!r}")

    @classmethod
    def from_dict(cls, d):
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown SLO objective keys {sorted(extra)}")
        return cls(**d)


def default_objectives(p99_gate_ms=500.0, failure_budget=0.0,
                       drift_gate=0.05, fast_window_s=15.0,
                       slow_window_s=60.0):
    """The standard serving triple: p99 latency on `serve.batch_ms`,
    failed-request rate on `soak.failed_requests`/`soak.requests`, and
    recall-proxy drift on the `soak.recall_drift` gauge. The soak harness
    (benchmarks/soak.py) maintains the soak.* metrics; a plain serve run
    that never registers them evaluates those objectives as burn 0."""
    return [
        SLOObjective(name="p99_latency", kind="latency",
                     metric="serve.batch_ms", threshold=float(p99_gate_ms),
                     fast_window_s=fast_window_s,
                     slow_window_s=slow_window_s,
                     warn_burn=0.75, page_burn=1.0),
        SLOObjective(name="failed_requests", kind="error_rate",
                     metric="soak.failed_requests", total="soak.requests",
                     threshold=float(failure_budget),
                     fast_window_s=fast_window_s,
                     slow_window_s=slow_window_s,
                     warn_burn=1.0, page_burn=1.0),
        SLOObjective(name="recall_drift", kind="gauge",
                     metric="soak.recall_drift", threshold=float(drift_gate),
                     fast_window_s=fast_window_s,
                     slow_window_s=slow_window_s,
                     warn_burn=0.75, page_burn=1.0),
    ]


class SLOMonitor:
    """Evaluates objectives against a registry's snapshot() time series.

    Usage:
        mon = SLOMonitor(engine.metrics, default_objectives())
        ...
        mon.evaluate()          # call periodically (a control loop / the
        mon.state               # /slo endpoint); OK | WARN | PAGE
        mon.verdict()           # summary dict for BENCH_soak.json
    """

    def __init__(self, registry, objectives, *, clock=time.monotonic,
                 event_capacity=256, max_samples=4096):
        if not objectives:
            raise ValueError("SLOMonitor needs at least one objective")
        self.registry = registry
        self.objectives = list(objectives)
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self._clock = clock
        self._max_samples = int(max_samples)
        # per objective: deque of (t, value, total_value) samples
        self._samples = {o.name: collections.deque(maxlen=self._max_samples)
                         for o in self.objectives}
        self._states = {o.name: OK for o in self.objectives}
        self._last = {o.name: {"state": OK, "value": None,
                               "burn_fast": 0.0, "burn_slow": 0.0}
                      for o in self.objectives}
        self.events = collections.deque(maxlen=int(event_capacity))
        self.n_evaluations = 0
        self._worst_state = OK
        self._page_count = 0
        self._warn_count = 0

    # -- config ------------------------------------------------------------

    @classmethod
    def from_config(cls, registry, config, **kw):
        """`config` is a dict {"objectives": [...]} or a path to a JSON
        file with that shape (the --slo-config format)."""
        if isinstance(config, str):
            with open(config) as f:
                config = json.load(f)
        objs = [SLOObjective.from_dict(d) for d in config["objectives"]]
        return cls(registry, objs, **kw)

    # -- sampling ----------------------------------------------------------

    @staticmethod
    def _read(snap, obj):
        """(value, total) sample for one objective from a snapshot dict.
        Unregistered metrics read as 0 — an objective over a metric the
        process never touched burns nothing."""
        if obj.kind == "latency":
            h = snap.get("histograms", {}).get(obj.metric) or {}
            return float(h.get("p99", 0.0) or 0.0), 0.0
        if obj.kind == "error_rate":
            c = snap.get("counters", {})
            return (float(c.get(obj.metric, 0) or 0),
                    float(c.get(obj.total, 0) or 0))
        g = snap.get("gauges", {})
        return float(g.get(obj.metric, 0.0) or 0.0), 0.0

    @staticmethod
    def _window(samples, now, window_s):
        """Samples inside [now - window_s, now], plus the newest older
        sample as the delta baseline (cumulative counters need a start
        point; without one the window starts at the oldest sample)."""
        cutoff = now - window_s
        inside, baseline = [], None
        for s in samples:
            if s[0] >= cutoff:
                inside.append(s)
            else:
                baseline = s
        return inside, baseline

    def _burn(self, obj, now):
        """(value, burn) over one window width for `obj`."""
        out = {}
        samples = self._samples[obj.name]
        for label, width in (("fast", obj.fast_window_s),
                             ("slow", obj.slow_window_s)):
            inside, baseline = self._window(samples, now, width)
            if not inside:
                out[label] = (0.0, 0.0)
                continue
            if obj.kind == "error_rate":
                first = baseline if baseline is not None else inside[0]
                last = inside[-1]
                d_err = last[1] - first[1]
                d_tot = last[2] - first[2]
                if d_err <= 0:
                    rate = 0.0
                elif d_tot <= 0:
                    rate = math.inf
                else:
                    rate = d_err / d_tot
                if obj.threshold > 0:
                    burn = rate / obj.threshold
                else:
                    burn = math.inf if rate > 0 else 0.0
                out[label] = (rate, burn)
            else:
                # latency/gauge: the windowed value is the worst sample
                value = max(abs(s[1]) for s in inside)
                burn = value / obj.threshold if obj.threshold > 0 \
                    else (math.inf if value > 0 else 0.0)
                out[label] = (value, burn)
        return out

    # -- evaluation --------------------------------------------------------

    def evaluate(self):
        """Sample the registry, update every objective's multi-window burn
        and state, log transitions. Returns {"t", "state", "objectives"}."""
        now = float(self._clock())
        snap = self.registry.snapshot()
        self.n_evaluations += 1
        results = {}
        for obj in self.objectives:
            value, total = self._read(snap, obj)
            self._samples[obj.name].append((now, value, total))
            burns = self._burn(obj, now)
            (vf, bf), (vs, bs) = burns["fast"], burns["slow"]
            if bf >= obj.page_burn and bs >= obj.page_burn:
                state = PAGE
            elif bf >= obj.warn_burn and bs >= obj.warn_burn:
                state = WARN
            else:
                state = OK
            prev = self._states[obj.name]
            if state != prev:
                self.events.append({
                    "t": round(now, 3), "objective": obj.name,
                    "from": prev, "to": state,
                    "value": round(vf, 6) if math.isfinite(vf) else vf,
                    "burn_fast": round(bf, 4) if math.isfinite(bf) else "inf",
                    "burn_slow": round(bs, 4) if math.isfinite(bs) else "inf",
                })
                self._states[obj.name] = state
                if state == PAGE:
                    self._page_count += 1
                elif state == WARN:
                    self._warn_count += 1
            if _SEVERITY[state] > _SEVERITY[self._worst_state]:
                self._worst_state = state
            self._last[obj.name] = {
                "state": state,
                "value": round(vf, 6) if math.isfinite(vf) else "inf",
                "burn_fast": round(bf, 4) if math.isfinite(bf) else "inf",
                "burn_slow": round(bs, 4) if math.isfinite(bs) else "inf",
            }
            results[obj.name] = self._last[obj.name]
        return {"t": round(now, 3), "state": self.state,
                "objectives": results}

    @property
    def state(self):
        """Current overall state: the worst of the per-objective states."""
        worst = OK
        for s in self._states.values():
            if _SEVERITY[s] > _SEVERITY[worst]:
                worst = s
        return worst

    def status(self):
        """Snapshot for the /slo endpoint: current state, last evaluation
        per objective, recent transition events."""
        return {"state": self.state,
                "n_evaluations": self.n_evaluations,
                "objectives": {o.name: dict(self._last[o.name],
                                            kind=o.kind, metric=o.metric,
                                            threshold=o.threshold)
                               for o in self.objectives},
                "events": list(self.events)}

    def verdict(self):
        """End-of-run judgement for BENCH_soak.json: final + worst state,
        page/warn transition counts, per-objective last burns."""
        return {"final_state": self.state,
                "worst_state": self._worst_state,
                "pages": self._page_count,
                "warns": self._warn_count,
                "n_evaluations": self.n_evaluations,
                "objectives": {o.name: dict(self._last[o.name],
                                            threshold=o.threshold)
                               for o in self.objectives},
                "ok": self._worst_state != PAGE}
