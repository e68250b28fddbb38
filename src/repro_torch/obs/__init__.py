"""repro_torch.obs: the port's observability surface, copies of the JAX
package's jax-free `repro.obs`:

  * MetricsRegistry (obs/registry.py) — counters, gauges and latency
    histograms, snapshot-able to a dict and to Prometheus text.
  * Tracer (obs/trace.py) — per-batch stage-span traces with JSONL and
    Chrome-trace exporters (per-host lanes for the router's spans).
  * SLOMonitor (obs/slo.py) — declarative objectives evaluated as
    multi-window burn rates, with an OK/WARN/PAGE state machine.
  * MetricsExporter (obs/exporter.py) — the live HTTP surface (/metrics,
    /metrics.json, /slo, /healthz) over a serving target's registry.
  * ExplainLogger (obs/explain.py) — sampled per-query explain records.

Nothing here imports torch or the engine, so any layer may depend on it.
"""

from repro_torch.obs.explain import ExplainLogger  # noqa: F401
from repro_torch.obs.exporter import MetricsExporter  # noqa: F401
from repro_torch.obs.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, write_metrics,
)
from repro_torch.obs.slo import (  # noqa: F401
    SLOMonitor, SLOObjective, default_objectives,
)
from repro_torch.obs.trace import (  # noqa: F401
    NOOP_SPAN, NOOP_TRACE, Span, Trace, Tracer, write_trace,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "write_metrics",
    "NOOP_SPAN", "NOOP_TRACE", "Span", "Trace", "Tracer", "write_trace",
    "SLOMonitor", "SLOObjective", "default_objectives",
    "MetricsExporter", "ExplainLogger",
]
