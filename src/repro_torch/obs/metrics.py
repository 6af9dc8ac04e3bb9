"""Named counters, gauges, and histograms with a JSON-safe `snapshot()`.

A `Metrics` registry rides on each `Tracer` (`tracer.metrics`) so the
instrumented pipeline reports scalar statistics — cache hit splits, rows
scored per backend, fused-group sizes, serve-slot occupancy — next to its
spans.  Everything is thread-safe (one registry lock + per-instrument
locks are avoided by keeping mutations O(1) under the registry lock);
the `NULL_METRICS` twin is the zero-overhead off path.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional


class Counter:
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self.value += n

    def snapshot(self) -> float:
        return self.value


class Gauge:
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def snapshot(self) -> Optional[float]:
        return self.value


class Histogram:
    """Retains observations; quantiles computed at snapshot time (the
    pipeline records at most a few thousand per run, so exactness beats
    streaming sketches here)."""
    __slots__ = ("name", "_obs", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._obs: List[float] = []
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._obs.append(float(v))

    @staticmethod
    def _quantile(sorted_obs: List[float], q: float) -> float:
        """Nearest-rank quantile over a sorted list."""
        i = min(len(sorted_obs) - 1, max(0, round(q * (len(sorted_obs) - 1))))
        return sorted_obs[i]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            obs = sorted(self._obs)
        if not obs:
            return {"count": 0}
        return {"count": len(obs), "sum": sum(obs),
                "mean": sum(obs) / len(obs),
                "p50": self._quantile(obs, 0.50),
                "p95": self._quantile(obs, 0.95),
                "max": obs[-1], "min": obs[0]}


class Metrics:
    """Get-or-create registry: `metrics.counter("cache.hits").inc()`."""

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            return h

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe dict: {"counters": {...}, "gauges": {...},
        "histograms": {name: {count,p50,p95,max,...}}}."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
        return {
            "counters": {c.name: c.snapshot() for c in counters},
            "gauges": {g.name: g.snapshot() for g in gauges},
            "histograms": {h.name: h.snapshot() for h in hists},
        }


class _NullInstrument:
    __slots__ = ()

    def inc(self, n: float = 1) -> None:
        return None

    def set(self, v: float) -> None:
        return None

    def observe(self, v: float) -> None:
        return None


_NULL_INSTRUMENT = _NullInstrument()


class NullMetrics:
    """Zero-overhead registry twin: every instrument is one shared no-op."""

    enabled = False

    def counter(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def snapshot(self) -> Dict[str, Any]:
        return {"counters": {}, "gauges": {}, "histograms": {}}


NULL_METRICS = NullMetrics()
