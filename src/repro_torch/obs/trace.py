"""Structured tracing for the exploration path: nestable host-side spans
and counters in a thread-safe in-memory buffer.

    tr = Tracer()
    with activate(tr):
        explore(...)                    # library spans land in tr
    tr.phase_times()                    # {"score": 0.41, ...} seconds

Design rules:

  * the default tracer everywhere is `NULL_TRACER`, whose `span()` returns
    one shared no-op context manager — the off path costs two attribute
    lookups and no allocation;
  * spans are host-side.  CUDA launches are asynchronous: a span that
    should include device time must bracket the copy back to the host
    (`.cpu()`) that waits for the result — every instrumented call site in
    `core.backend` and `search.batch_frontier` copies to the host inside
    its span, so device time lands in the span that launched the work;
  * instrumented library code (mapper, backend) reads the *ambient* tracer
    via `current_tracer()` instead of growing a `tracer=` parameter on
    every function; `activate(tr)` scopes it (contextvar — safe across
    threads and nested calls).

Spans flagged `phase=True` are non-overlapping pipeline phases (pack /
validate / score ...); `phase_times()` sums exactly those, so nested
detail spans never double count.
"""
from __future__ import annotations

import contextvars
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Span:
    """One finished (or open) span.  Times are `time.perf_counter()`
    seconds."""
    name: str
    t0: float
    t1: Optional[float] = None
    depth: int = 0
    parent: Optional[int] = None        # index into the buffer's span list
    index: int = -1
    thread: int = 0
    phase: bool = False
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0


class TraceBuffer:
    """Thread-safe store of finished spans + named counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}

    def append(self, span: Span) -> int:
        with self._lock:
            span.index = len(self.spans)
            self.spans.append(span)
            return span.index

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self.spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self.spans)

    def phase_times(self) -> Dict[str, float]:
        """Total seconds per phase-flagged span name."""
        out: Dict[str, float] = {}
        for s in self.snapshot():
            if s.phase and s.t1 is not None:
                out[s.name] = out.get(s.name, 0.0) + s.duration
        return out

    def span_times(self) -> Dict[str, float]:
        """Total seconds per span name, phase-flagged or not."""
        out: Dict[str, float] = {}
        for s in self.snapshot():
            if s.t1 is not None:
                out[s.name] = out.get(s.name, 0.0) + s.duration
        return out


class _SpanCtx:
    """Live span handle: a context manager that records on exit.
    `set(**attrs)` attaches attributes discovered mid-span."""
    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def set(self, **attrs) -> "_SpanCtx":
        self._span.attrs.update(attrs)
        return self

    def __enter__(self) -> "_SpanCtx":
        return self

    def __exit__(self, *exc) -> None:
        self._span.t1 = time.perf_counter()
        self._tracer._pop(self._span)
        return None


class _NullSpan:
    """Shared no-op span: the entire cost of tracing when it is off."""
    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


class Tracer:
    """Records nestable spans and counters into a `TraceBuffer`.

    Nesting is tracked per thread (a `threading.local` stack).  Metrics
    (`obs.metrics.Metrics`) ride along so instrumented code reaches both
    through one handle."""

    enabled = True

    def __init__(self, buffer: Optional[TraceBuffer] = None, metrics=None):
        from .metrics import Metrics
        self.buffer = buffer or TraceBuffer()
        self.metrics = metrics if metrics is not None else Metrics()
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, phase: bool = False, **attrs) -> _SpanCtx:
        st = self._stack()
        parent = st[-1] if st else None
        s = Span(name=name, t0=time.perf_counter(), depth=len(st),
                 parent=parent.index if parent else None,
                 thread=threading.get_ident(), phase=phase, attrs=attrs)
        self.buffer.append(s)           # index assigned on append, so
        st.append(s)                    # children can reference it
        return _SpanCtx(self, s)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        elif span in st:                # tolerate out-of-order exits
            st.remove(span)

    def count(self, name: str, n: float = 1) -> None:
        self.buffer.count(name, n)

    def phase_times(self) -> Dict[str, float]:
        return self.buffer.phase_times()

    def span_times(self) -> Dict[str, float]:
        return self.buffer.span_times()


class NullTracer:
    """The default tracer: every operation is a no-op.  `span()` hands
    back one shared object, so a disabled hot path allocates nothing."""

    enabled = False

    def __init__(self):
        from .metrics import NULL_METRICS
        self.buffer = None
        self.metrics = NULL_METRICS

    def span(self, name: str, phase: bool = False, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def count(self, name: str, n: float = 1) -> None:
        return None

    def phase_times(self) -> Dict[str, float]:
        return {}

    def span_times(self) -> Dict[str, float]:
        return {}


NULL_TRACER = NullTracer()

_ACTIVE: "contextvars.ContextVar[object]" = contextvars.ContextVar(
    "repro_torch_obs_tracer", default=NULL_TRACER)


def current_tracer():
    """The ambient tracer instrumented library code records into
    (`NULL_TRACER` unless a scope activated one)."""
    return _ACTIVE.get()


class _Activation:
    __slots__ = ("_tracer", "_token")

    def __init__(self, tracer):
        self._tracer = tracer
        self._token = None

    def __enter__(self):
        self._token = _ACTIVE.set(self._tracer)
        return self._tracer

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)
        return None


def activate(tracer) -> _Activation:
    """Scope `tracer` as the ambient tracer:

        with activate(tr):
            explore(...)                # library spans land in tr
    """
    return _Activation(tracer)
