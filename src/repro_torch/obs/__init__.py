"""repro_torch.obs — dependency-free observability for the exploration path.

  trace      nestable host-side spans + counters in a thread-safe buffer;
             `NULL_TRACER` is the zero-overhead default and `activate()`
             scopes an ambient tracer for library code
  metrics    named counters / gauges / histograms with a JSON-safe
             `snapshot()`
"""
from .metrics import (NULL_METRICS, Counter, Gauge, Histogram, Metrics,
                      NullMetrics)
from .trace import (NULL_TRACER, NullTracer, Span, TraceBuffer, Tracer,
                    activate, current_tracer)

__all__ = [n for n in dir() if not n.startswith("_")]
