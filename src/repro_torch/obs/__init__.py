"""repro_torch.obs — dependency-free observability for the DSE pipeline.

  trace      nestable host-side spans + counters -> thread-safe
             TraceBuffer with JSONL and Chrome trace_event
             (chrome://tracing / Perfetto) export; `NULL_TRACER` is the
             zero-overhead default and `activate()` scopes an ambient
             tracer for library code
  metrics    named counters / gauges / histograms with a JSON-safe
             `snapshot()`
  progress   typed ProgressEvent stream (arch evaluated/skipped, cache
             lookup, frontier grew, round finished) with pluggable sinks —
             `verbose=True` is the ConsoleSink
  manifest   RunManifest: git sha, engine, torch device and card, space /
             constraints digests, wall time by phase — written alongside
             cached results
"""
from .manifest import (MANIFEST_DIR, RunManifest, build_manifest, git_sha,
                       space_digest)
from .metrics import (NULL_METRICS, Counter, Gauge, Histogram, Metrics,
                      NullMetrics)
from .progress import (EVENT_KINDS, CollectSink, ConsoleSink, EventCursor,
                       ProgressEvent, ProgressStream, ReplaySink, as_stream)
from .trace import (DRIVER_PHASES, MODEL_SPANS, NULL_TRACER, PHASES,
                    NullTracer, Span, TraceBuffer, Tracer, activate,
                    as_tracer, current_tracer, deferred_sync, family_of)

__all__ = [n for n in dir() if not n.startswith("_")]
