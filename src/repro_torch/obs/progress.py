"""Progress events: a typed stream of "what the search just did".

`run_search` emits `ProgressEvent`s — an architecture evaluated or
statically skipped, a cache lookup resolved, the Pareto frontier growing,
a strategy round finishing — into a `ProgressStream` with pluggable
sinks.  This is the seed of the DSE-as-a-service client-streaming
channel: a service wraps a queue-backed sink and forwards incremental
frontier updates to clients as rounds complete.

`verbose=True` is now just the `ConsoleSink` subscribed to this stream;
it renders per-architecture lines byte-identical to the old ad-hoc
`print()` branches, so existing users see exactly the same output from
one code path.

With no sinks subscribed, `emit()` returns before building the event —
the off path costs one attribute check.
"""
from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

# event kinds emitted by the driver and the DSE service
EVENT_KINDS = (
    "arch-evaluated",       # one fresh architecture scored
    "arch-skipped",         # rejected by a static constraint check
    "cache-lookup",         # one per-workload cache consult (hit/tier)
    "frontier-grew",        # the Pareto frontier accepted a point
    "round-finished",       # one strategy round completed
    "search-finished",      # run_search returning
    "job-admitted",         # DSEService created a fresh job for a query
    "job-coalesced",        # a submit attached to an already-running job
    "job-cancelled",        # cancellation latched (client or deadline)
    "job-finished",         # job retired (done / cancelled / failed)
)


@dataclasses.dataclass
class ProgressEvent:
    kind: str
    t_wall: float
    payload: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "t_wall": self.t_wall, **self.payload}


Sink = Callable[[ProgressEvent], None]


class ProgressStream:
    """Fan-out of ProgressEvents to subscribed sinks (callables)."""

    def __init__(self, sinks: Optional[List[Sink]] = None):
        self.sinks: List[Sink] = list(sinks or [])

    @property
    def active(self) -> bool:
        return bool(self.sinks)

    def subscribe(self, sink: Sink) -> Sink:
        self.sinks.append(sink)
        return sink

    def emit(self, kind: str, **payload) -> None:
        if not self.sinks:
            return
        ev = ProgressEvent(kind=kind, t_wall=time.time(), payload=payload)
        for sink in self.sinks:
            sink(ev)


class ConsoleSink:
    """Renders per-architecture events in the historical `verbose=True`
    format (identical strings — asserted in tests); other event kinds are
    silent by default so verbose output is unchanged."""

    def __init__(self, stream=None, all_events: bool = False):
        self.stream = stream or sys.stdout
        self.all_events = all_events

    def __call__(self, ev: ProgressEvent) -> None:
        p = ev.payload
        if ev.kind == "arch-evaluated":
            print(f"  {p['arch']:28s} "
                  f"cycles={p['cycles']:.3e} "
                  f"energy={p['energy_pj']:.3e}pJ edp={p['edp']:.3e}"
                  + ("" if p.get("feasible", True) else "  [infeasible]"),
                  file=self.stream)
        elif ev.kind == "arch-skipped":
            print(f"  {p['arch']:28s} statically "
                  f"infeasible (violation "
                  f"{p['violation']:.3f})", file=self.stream)
        elif self.all_events:
            print(f"  [{ev.kind}] " + " ".join(
                f"{k}={v}" for k, v in p.items()), file=self.stream)


class CollectSink:
    """Test/service helper: retains every event (optionally filtered)."""

    def __init__(self, kinds: Optional[tuple] = None):
        self.kinds = kinds
        self.events: List[ProgressEvent] = []

    def __call__(self, ev: ProgressEvent) -> None:
        if self.kinds is None or ev.kind in self.kinds:
            self.events.append(ev)

    def of(self, kind: str) -> List[ProgressEvent]:
        return [e for e in self.events if e.kind == kind]


_END = object()  # close sentinel pushed to every cursor queue


class EventCursor:
    """One subscriber's view of a :class:`ReplaySink`.

    Yields the sink's full event history (replayed in emission order)
    followed by live events as they arrive, and ends when the sink is
    closed.  Safe to consume from any thread.
    """

    def __init__(self) -> None:
        self._q: "queue.Queue" = queue.Queue()
        self._ended = False

    def get(self, timeout: Optional[float] = None) -> Optional[ProgressEvent]:
        """Next event, blocking up to `timeout` seconds.  Returns None
        once the stream has ended; raises TimeoutError on timeout."""
        if self._ended:
            return None
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"no event within {timeout}s (stream still open)") from None
        if item is _END:
            self._ended = True
            return None
        return item

    def __iter__(self) -> Iterator[ProgressEvent]:
        while True:
            ev = self.get()
            if ev is None:
                return
            yield ev

    def drain(self, timeout: Optional[float] = None) -> List[ProgressEvent]:
        """Collect every remaining event until the stream ends.  The
        timeout applies per event, not to the whole drain."""
        out: List[ProgressEvent] = []
        while True:
            ev = self.get(timeout=timeout)
            if ev is None:
                return out
            out.append(ev)


class ReplaySink:
    """Buffered fan-out sink with replay: the client channel of the DSE
    service.

    Every event is appended to an ordered history and forwarded to all
    live cursors.  `subscribe()` atomically preloads the history into a
    fresh cursor before registering it for live events, so a late
    subscriber sees exactly the same monotone stream as one attached
    from the start — no gaps, no duplicates.  Subscribing after
    `close()` still replays the full history (ending immediately), which
    is what lets clients attach to already-finished jobs.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._history: List[ProgressEvent] = []
        self._cursors: List[EventCursor] = []
        self._closed = False

    @property
    def closed(self) -> bool:
        return self._closed

    def __call__(self, ev: ProgressEvent) -> None:
        with self._lock:
            if self._closed:
                raise RuntimeError("ReplaySink is closed")
            self._history.append(ev)
            for cur in self._cursors:
                cur._q.put(ev)

    def subscribe(self) -> EventCursor:
        cur = EventCursor()
        with self._lock:
            for ev in self._history:
                cur._q.put(ev)
            if self._closed:
                cur._q.put(_END)
            else:
                self._cursors.append(cur)
        return cur

    def close(self) -> None:
        """End the stream: live cursors see the end after the last
        event; future subscribers get replay-then-end."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for cur in self._cursors:
                cur._q.put(_END)
            self._cursors = []

    def events(self) -> List[ProgressEvent]:
        """Snapshot of the history so far."""
        with self._lock:
            return list(self._history)


def as_stream(progress) -> ProgressStream:
    """Normalize a user-facing `progress=` argument: None -> inert
    stream, a ProgressStream -> itself, a callable (or list of
    callables) -> stream subscribed to them."""
    if progress is None:
        return ProgressStream()
    if isinstance(progress, ProgressStream):
        return progress
    if callable(progress):
        return ProgressStream([progress])
    return ProgressStream(list(progress))
