"""repro_torch.obs: the metrics registry and stage tracer the engine, the
index writer and the update path report through (copies of the JAX
package's jax-free `repro.obs` registry, tracer and explain log, with
their file exporters; the SLO monitor and the HTTP exporter wait)."""

from repro_torch.obs.explain import ExplainLogger  # noqa: F401
from repro_torch.obs.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, write_metrics,
)
from repro_torch.obs.trace import (  # noqa: F401
    NOOP_SPAN, NOOP_TRACE, Span, Trace, Tracer, write_trace,
)

__all__ = ["Counter", "ExplainLogger", "Gauge", "Histogram", "MetricsRegistry",
           "NOOP_SPAN", "NOOP_TRACE", "Span", "Trace", "Tracer",
           "write_metrics", "write_trace"]
