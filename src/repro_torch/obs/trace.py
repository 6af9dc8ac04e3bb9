"""Structured tracing for the DSE pipeline: nestable host-side spans,
counters, JSONL + Chrome `trace_event` export.

A `Tracer` records *host-side* spans into a thread-safe in-memory
`TraceBuffer`:

    tr = Tracer()
    with tr.span("score", phase=True, rows=4096):
        ...
    tr.export_chrome("trace.json")      # load in chrome://tracing/Perfetto
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
  * instrumented library code (mapper, backend, cache) reads the *ambient*
    tracer via `current_tracer()` instead of growing a `tracer=` parameter
    on every function; `activate(tr)` scopes it (contextvar — safe across
    threads and nested searches).

Spans flagged `phase=True` are the driver's non-overlapping pipeline
phases (propose / static-filter / pack / validate / score / cache-* /
assemble / frontier-update, plus the streaming driver's prefetch-build /
device-wait / cache-flush); `phase_times()` sums exactly those, so
nested detail spans (kernel groups, per-lookup cache gets) never double
count.  Phase spans never nest inside each other *on one thread*; the
streaming driver's worker thread legitimately holds pack/validate spans
while the main thread sits in device-wait, so summed phase time may
exceed wall time exactly when host and device genuinely overlapped.
`span_times()` sums every span by name, phase-flagged or not.
"""
from __future__ import annotations

import contextvars
import dataclasses
import io
import json
import threading
import time
from typing import Any, Dict, List, Optional

#: The driver's non-overlapping pipeline phases, in pipeline order: the
#: one canonical source for `phase=True` span names.
DRIVER_PHASES = ("propose", "static-filter", "pack", "validate",
                 "cache-get", "prefetch-build", "score", "device-wait",
                 "cache-put", "assemble", "frontier-update",
                 "cache-flush")

#: All phase-flagged span names repo-wide: the driver phases plus the
#: serving engine's per-tick phase.
PHASES = DRIVER_PHASES + ("serve.tick",)

# ---------------------------------------------------------------------------
# span records
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Span:
    """One finished (or open) span.  Times are `time.perf_counter()`
    seconds; `t_wall0` anchors the buffer to the unix clock once."""
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

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "depth": self.depth, "parent": self.parent,
                "index": self.index, "thread": self.thread,
                "phase": self.phase, "attrs": self.attrs}


def family_of(name: str) -> str:
    """Lane grouping for the Chrome export: the part before the first
    '.' ("backend.jnp" -> "backend"); bare names are their own family."""
    return name.split(".", 1)[0]


class TraceBuffer:
    """Thread-safe store of finished spans + named counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}
        self.t_wall0 = time.time()
        self.t_perf0 = time.perf_counter()

    # -- recording -------------------------------------------------------
    def append(self, span: Span) -> int:
        with self._lock:
            span.index = len(self.spans)
            self.spans.append(span)
            return span.index

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    # -- views -----------------------------------------------------------
    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self.spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self.spans)

    def phase_times(self) -> Dict[str, float]:
        """Total seconds per phase-flagged span name (the driver's
        non-overlapping pipeline phases — see module docstring)."""
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

    # -- exports ---------------------------------------------------------
    def to_jsonl(self) -> str:
        """One JSON object per line: a `meta` header, then every span in
        record order, then one `counters` line."""
        buf = io.StringIO()
        buf.write(json.dumps({"meta": {"t_wall0": self.t_wall0,
                                       "t_perf0": self.t_perf0,
                                       "n_spans": len(self)}}) + "\n")
        for s in self.snapshot():
            buf.write(json.dumps({"span": s.to_dict()}) + "\n")
        with self._lock:
            counters = dict(self.counters)
        buf.write(json.dumps({"counters": counters}) + "\n")
        return buf.getvalue()

    @staticmethod
    def from_jsonl(text: str) -> "TraceBuffer":
        """Rebuild a buffer from `to_jsonl()` output (round-trip tested)."""
        buf = TraceBuffer()
        for line in text.splitlines():
            if not line.strip():
                continue
            row = json.loads(line)
            if "meta" in row:
                buf.t_wall0 = row["meta"]["t_wall0"]
                buf.t_perf0 = row["meta"]["t_perf0"]
            elif "span" in row:
                d = row["span"]
                buf.spans.append(Span(
                    name=d["name"], t0=d["t0"], t1=d["t1"],
                    depth=d["depth"], parent=d["parent"],
                    index=d["index"], thread=d["thread"],
                    phase=d["phase"], attrs=d["attrs"]))
            elif "counters" in row:
                buf.counters.update(row["counters"])
        return buf

    def chrome_trace(self) -> Dict[str, Any]:
        """`trace_event`-format dict for chrome://tracing / Perfetto.

        One pid (the search process); one tid lane per span-name *family*
        so e.g. all `backend.*` dispatch spans share a lane separate from
        the driver phases.  Spans within a lane nest by time containment
        ("X" complete events), which matches the recorded nesting because
        families follow the call structure."""
        events: List[Dict[str, Any]] = [{
            "ph": "M", "pid": 0, "tid": 0, "name": "process_name",
            "args": {"name": "repro-dse"}}]
        lanes: Dict[str, int] = {}
        spans = self.snapshot()
        for s in spans:
            fam = family_of(s.name)
            if fam not in lanes:
                lanes[fam] = len(lanes)
                events.append({"ph": "M", "pid": 0, "tid": lanes[fam],
                               "name": "thread_name",
                               "args": {"name": fam}})
        for s in spans:
            if s.t1 is None:
                continue
            args = {k: v for k, v in s.attrs.items()}
            if s.phase:
                args["phase"] = True
            events.append({
                "ph": "X", "pid": 0, "tid": lanes[family_of(s.name)],
                "name": s.name, "cat": "phase" if s.phase else "detail",
                "ts": (s.t0 - self.t_perf0) * 1e6,      # microseconds
                "dur": s.duration * 1e6,
                "args": args})
        with self._lock:
            counters = dict(self.counters)
        for name, val in sorted(counters.items()):
            events.append({"ph": "C", "pid": 0, "tid": 0, "name": name,
                           "ts": (time.perf_counter() - self.t_perf0) * 1e6,
                           "args": {"value": val}})
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"t_wall0": self.t_wall0}}


# ---------------------------------------------------------------------------
# tracers
# ---------------------------------------------------------------------------
class _SpanCtx:
    """Live span handle: a context manager that records on exit.
    `set(**attrs)` attaches attributes discovered mid-span (row counts,
    group sizes)."""
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

    Nesting is tracked per thread (a `threading.local` stack), so
    concurrent recorders interleave safely and each thread's spans parent
    correctly.  Metrics (`obs.metrics.Metrics`) ride along so instrumented
    code reaches both through one handle."""

    enabled = True

    def __init__(self, buffer: Optional[TraceBuffer] = None, metrics=None):
        from .metrics import Metrics
        self.buffer = buffer or TraceBuffer()
        self.metrics = metrics if metrics is not None else Metrics()
        self._local = threading.local()

    # -- span stack ------------------------------------------------------
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

    # -- counters / convenience -----------------------------------------
    def count(self, name: str, n: float = 1) -> None:
        self.buffer.count(name, n)

    def phase_times(self) -> Dict[str, float]:
        return self.buffer.phase_times()

    def span_times(self) -> Dict[str, float]:
        return self.buffer.span_times()

    def export_jsonl(self, path: str) -> str:
        text = self.buffer.to_jsonl()
        with open(path, "w") as f:
            f.write(text)
        return path

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.buffer.chrome_trace(), f)
        return path


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

# ---------------------------------------------------------------------------
# ambient tracer (contextvar: thread- and nesting-safe)
# ---------------------------------------------------------------------------
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
            run_search(...)             # library spans land in tr
    """
    return _Activation(tracer)


def deferred_sync(fn):
    """Mark `fn` as a *deferred-sync producer*: it deliberately returns
    device tensors whose work is enqueued but not waited for, so a later
    consumer can overlap host work with device execution before copying
    the results back.  A plain marker: the decorator returns `fn` as it
    is, tagged `__deferred_sync__`.  Callers launch such a function inside
    a trace span, and whoever copies its results to the host does so
    inside one too (the streaming driver's "device-wait" phase)."""
    fn.__deferred_sync__ = True
    return fn


def as_tracer(trace) -> object:
    """Normalize a user-facing `trace=` argument:

    None       -> the ambient tracer (NULL_TRACER unless activated)
    False      -> NULL_TRACER (force off, even under an active ambient)
    True       -> a fresh recording Tracer
    a Tracer   -> itself
    """
    if trace is None:
        return current_tracer()
    if trace is False:
        return NULL_TRACER
    if trace is True:
        return Tracer()
    if hasattr(trace, "span") and hasattr(trace, "count"):
        return trace
    raise TypeError(f"trace must be None, a bool, or a Tracer-like "
                    f"object, got {type(trace).__name__}")
