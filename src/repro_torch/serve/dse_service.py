"""DSE-as-a-service: a persistent, concurrent, coalescing search server.

`DSEService` wraps `search.driver.run_search` in a warm process that
accepts concurrent search queries (space, workload(s), constraints,
strategy, budget).  Each query canonicalizes to a content digest built
from the same signature machinery as the result-cache key
(`_workload_sig`/`_hw_sig`/`_cfg_sig`, `ConstraintSet.signature`), and
**identical in-flight requests coalesce onto one running job**: the
first submit creates the job, later submits attach to it, and every
subscriber — early or late — receives the same monotone `ProgressEvent`
stream (a replay of the job's history followed by live events, via
`obs.progress.ReplaySink`) ending in bit-identical winners.

Jobs run on a bounded worker pool sharing one warm `ResultCache` tier
(the cache dir's O_EXCL GC lock already makes it multi-process safe), so
a digest that misses the coalescing window still hits warm per-workload
results.  Per-job cancellation and deadlines ride the driver's
cooperative `cancel=` hook: a fired cancel lets the in-flight round
finish and returns a *partial* but internally consistent frontier.

Observability: `service.admit` / `service.coalesce` / `service.job`
tracing spans, admitted/coalesced/completed/cancelled counters plus a
queue-depth gauge on the tracer's metrics, a `ServiceStats` snapshot,
and one provenance `RunManifest` per job (written beside the disk cache
when the service has one).

Service-level event kinds (`job-admitted`, `job-coalesced`,
`job-cancelled`, `job-finished`) frame the driver's own events in each
job's stream, so a client can follow a job's full lifecycle from its
cursor alone.

Device: `DSEService(device=...)` (default "cuda") resolves its scoring
device once, at construction — raising on a host without a card — and
every job passes it to `run_search` explicitly, inside
`torch.cuda.device(...)`: a pool thread's current CUDA device is not the
caller's.  The device is not part of a query's digest: it changes where
the scoring runs, not what `run_search` returns.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import torch

from ..core.mapper import MapperConfig
from ..core.scheduler import SCHEDULER_FORMAT, MixDesc
from ..core.task_analyst import TaskDescription, TaskWorkloads, analyze
from ..obs import (MANIFEST_DIR, EventCursor, ProgressEvent, ProgressStream,
                   ReplaySink, activate, as_tracer, build_manifest)
from ..device import as_device, on_device
from ..search.cache import ResultCache, _cfg_sig, _hw_sig, _workload_sig
from ..search.constraints import ConstraintSet
from ..search.driver import SearchReport, run_search
from ..search.pareto import DEFAULT_OBJECTIVES
from ..search.space import ArchSpace, as_space
from ..search.strategies import STRATEGIES

#: request-digest schema version — bump on any change to
#: `SearchQuery.signature()` so old and new digests never alias
#: (v2: heterogeneous-mix point signatures joined `_space_sig`)
SERVICE_FORMAT = 2

#: `_space_sig` materializes the hardware signature of every lattice
#: point (the axes alone don't pin `ArchSpace.from_archs` builders, whose
#: axis values are just indices); cap how far that is allowed to go
MAX_DIGEST_ARCHS = 4096

# job lifecycle states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"
FAILED = "failed"

_UNSET = object()


def _point_sig(hw) -> Dict[str, Any]:
    """Content identity of one design point.  A heterogeneous mix
    canonicalizes its member *order* (the scheduler may assign work to
    any member, and swapping two members permutes assignments without
    changing any reachable outcome), so two mixes listing the same
    members in different orders coalesce; `SCHEDULER_FORMAT` rides
    along so a semantics change never aliases old digests."""
    if isinstance(hw, MixDesc):
        members = sorted(
            (_hw_sig(m) for m in hw.members),
            key=lambda sig: json.dumps(sig, sort_keys=True))
        return {"mix": members, "scheduler": SCHEDULER_FORMAT}
    return _hw_sig(hw)


def _space_sig(space: ArchSpace) -> Dict[str, Any]:
    """Content identity of an architecture lattice: the axes plus the
    full point signature of every design (hardware, or canonicalized
    mix).  Unlike `obs.manifest.space_digest` (axis names + repr'd
    values — fine for provenance), this is *content*-sensitive even for
    `ArchSpace.from_archs`, whose axis values are plain indices."""
    if space.size > MAX_DIGEST_ARCHS:
        raise ValueError(
            f"space too large to content-digest ({space.size} > "
            f"{MAX_DIGEST_ARCHS} designs); shrink the lattice or raise "
            f"MAX_DIGEST_ARCHS")
    axes = {n: [str(v) for v in vals]
            for n, vals in zip(space.axis_names, space.axis_values)}
    archs = [_point_sig(space.at(c)) for c in space.all_coords()]
    return {"axes": axes, "archs": archs}


@dataclasses.dataclass
class SearchQuery:
    """One design-space search request, canonicalized at construction.

    `strategy` must be a registry *name* (instances are stateful and
    cannot be safely shared between coalesced clients).  `overlap` is
    deliberately excluded from the digest: it only changes *when* the
    host blocks, never what is evaluated — winners are bit-identical
    either way, so requests differing only in `overlap` coalesce.
    `backend` is the port's engine name ("auto" resolves to "cuda").
    """
    task: Union[TaskDescription, TaskWorkloads]
    space: Any
    goal: str = "edp"
    strategy: str = "exhaustive"
    budget: Optional[int] = None
    cfg: Optional[MapperConfig] = None
    constraints: Any = None
    backend: str = "auto"
    objectives: Sequence[str] = DEFAULT_OBJECTIVES
    seed: int = 0
    batching: str = "fused"
    round_size: Union[int, str] = 8
    overlap: Union[str, bool] = "auto"   # scheduling only — not in digest
    use_packed: bool = True
    cache_level: str = "Gbuf"
    strategy_params: Optional[Dict[str, Any]] = None

    def __post_init__(self) -> None:
        from ..core.backend import resolve_backend
        if not isinstance(self.strategy, str):
            raise TypeError(
                "SearchQuery.strategy must be a registry name (str); "
                "strategy *instances* are stateful and cannot be "
                "coalesced across clients")
        if self.strategy not in STRATEGIES:
            raise KeyError(f"unknown strategy {self.strategy!r}; "
                           f"registered: {sorted(STRATEGIES)}")
        if self.batching not in ("fused", "per-arch"):
            raise ValueError(f"batching must be 'fused' or 'per-arch', "
                             f"got {self.batching!r}")
        # canonical forms: admission-time validation + digest inputs
        self.workloads: TaskWorkloads = (
            self.task if isinstance(self.task, TaskWorkloads)
            else analyze(self.task))
        self.space_obj: ArchSpace = as_space(self.space)
        self.cset: Optional[ConstraintSet] = \
            ConstraintSet.from_any(self.constraints)
        self.mapper_cfg: MapperConfig = self.cfg or MapperConfig()
        self.resolved_backend: str = resolve_backend(self.backend)
        # same clamp as the driver, so `budget=None`, `budget=size`, and
        # any over-budget all canonicalize to the same digest
        self.canonical_budget: int = (
            self.space_obj.size if self.budget is None
            else max(1, min(int(self.budget), self.space_obj.size)))
        self._digest: Optional[str] = None

    def signature(self) -> Dict[str, Any]:
        """JSON-safe canonical identity — every field that changes what
        `run_search` computes, none that only changes how fast."""
        wls = self.workloads
        cons = None
        if self.cset is not None:
            sig = self.cset.signature()
            # ConstraintSet.digest is order-sensitive (list order); an
            # AND-conjunction is not, so the service identity sorts it
            sig["constraints"] = sorted(
                sig["constraints"],
                key=lambda c: (c["metric"], c["sense"], c["bound"]))
            cons = sig
        return {
            "v": SERVICE_FORMAT,
            "task": {
                "intra": [_workload_sig(w) for w in wls.intra],
                "preproc": [[i, dataclasses.asdict(w)]
                            for i, w in wls.preproc],
                "activations": [dataclasses.asdict(a)
                                for a in wls.activations],
            },
            "space": _space_sig(self.space_obj),
            "goal": self.goal,
            "strategy": self.strategy,
            "strategy_params": self.strategy_params or {},
            "budget": self.canonical_budget,
            "seed": self.seed,
            "backend": self.resolved_backend,
            "cfg": _cfg_sig(self.mapper_cfg),
            "objectives": list(self.objectives),
            "batching": self.batching,
            "round_size": self.round_size,
            "use_packed": self.use_packed,
            "cache_level": self.cache_level,
            "constraints": cons,
        }

    def digest(self) -> str:
        """Content digest: the coalescing identity.  Memoized — the
        space signature materializes every lattice point once."""
        if self._digest is None:
            blob = json.dumps(self.signature(), sort_keys=True,
                              default=str)
            self._digest = hashlib.sha256(blob.encode()).hexdigest()
        return self._digest


@dataclasses.dataclass
class ServiceStats:
    """Monotone service counters (gauges live on the tracer metrics)."""
    admitted: int = 0        # fresh jobs created
    coalesced: int = 0       # submits served by an in-flight job
    completed: int = 0       # jobs that ran to completion
    cancelled: int = 0       # jobs stopped early (client or deadline)
    expired: int = 0         # subset of cancelled: deadline fired
    failed: int = 0          # jobs that raised

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class SearchJob:
    """One coalesced search execution: a ReplaySink-backed event stream,
    a cancellation latch, a deadline, and the final report."""

    def __init__(self, digest: str, query: SearchQuery, *,
                 deadline: Optional[float] = None,
                 clock=time.monotonic):
        self.digest = digest
        self.query = query
        self.status = QUEUED
        self.sink = ReplaySink()
        self.stream = ProgressStream([self.sink])
        self.report: Optional[SearchReport] = None
        self.error: Optional[BaseException] = None
        self.cancel_reason: Optional[str] = None
        self.n_clients = 0
        self.deadline = deadline         # absolute, on the service clock
        self._clock = clock
        self._cancel = threading.Event()
        self._done = threading.Event()
        self._lock = threading.Lock()

    # -- event stream ----------------------------------------------------
    def emit(self, kind: str, **payload) -> bool:
        """Emit into the job stream iff it is still open (attach/cancel
        race with job completion; closure holds the same lock)."""
        with self._lock:
            if self.sink.closed:
                return False
            self.stream.emit(kind, **payload)
            return True

    def add_sink(self, sink) -> None:
        """Subscribe a live tap (no replay — use `sink.subscribe()` via
        a ticket for the replay-then-live contract)."""
        self.stream.subscribe(sink)

    # -- cancellation / deadline -----------------------------------------
    def cancel(self, reason: str = "client") -> bool:
        """Latch cancellation; False if the job already finished.  The
        first latch wins the reason and emits `job-cancelled`."""
        with self._lock:
            if self._done.is_set():
                return False
            first = not self._cancel.is_set()
            if first:
                self.cancel_reason = reason
            self._cancel.set()
        if first:
            self.emit("job-cancelled", digest=self.digest[:16],
                           reason=reason)
        return True

    def should_stop(self) -> bool:
        """The driver's `cancel=` hook, checked at every round
        boundary: client latch or deadline expiry."""
        if self._cancel.is_set():
            return True
        if self.deadline is not None and self._clock() >= self.deadline:
            self.cancel("deadline")
            return True
        return False

    def extend_deadline(self, deadline: Optional[float]) -> None:
        """Coalesced submits only ever *loosen* the deadline: the most
        patient subscriber wins (None = no deadline)."""
        with self._lock:
            if deadline is None:
                self.deadline = None
            elif self.deadline is not None:
                self.deadline = max(self.deadline, deadline)

    # -- completion ------------------------------------------------------
    def _finish(self, report: SearchReport) -> None:
        with self._lock:
            self.report = report
            self.status = CANCELLED if report.cancelled else DONE
            self.stream.emit(
                "job-finished", digest=self.digest[:16],
                status=self.status, reason=self.cancel_reason,
                best_arch=report.best.hardware.name,
                best_value=report.goal_value(),
                n_evaluated=report.n_evaluated,
                pareto_size=len(report.pareto),
                run_id=(report.manifest.run_id if report.manifest
                        else None))
            self.sink.close()
            self._done.set()

    def _fail(self, error: BaseException) -> None:
        with self._lock:
            self.error = error
            self.status = FAILED
            self.stream.emit("job-finished", digest=self.digest[:16],
                             status=FAILED, reason=self.cancel_reason,
                             error=repr(error))
            self.sink.close()
            self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> SearchReport:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"job {self.digest[:16]} still {self.status} after "
                f"{timeout}s")
        if self.error is not None:
            raise self.error
        return self.report


@dataclasses.dataclass
class SearchTicket:
    """A client's handle on a (possibly shared) job: its private event
    cursor plus result/cancel access."""
    job: SearchJob
    cursor: EventCursor
    coalesced: bool          # True when this submit attached to a job
                             # another client started

    @property
    def digest(self) -> str:
        return self.job.digest

    @property
    def status(self) -> str:
        return self.job.status

    def events(self, timeout: Optional[float] = None) \
            -> Iterator[ProgressEvent]:
        """Replay-then-live event iterator; ends when the job retires.
        `timeout` bounds the wait per event."""
        while True:
            ev = self.cursor.get(timeout=timeout)
            if ev is None:
                return
            yield ev

    def drain(self, timeout: Optional[float] = None) -> List[ProgressEvent]:
        return self.cursor.drain(timeout=timeout)

    def result(self, timeout: Optional[float] = None) -> SearchReport:
        return self.job.result(timeout=timeout)

    def cancel(self, reason: str = "client") -> bool:
        return self.job.cancel(reason)


class DSEService:
    """Persistent concurrent search service with request coalescing.

    workers           : worker-pool width (concurrent jobs)
    cache             : shared warm tier — a ResultCache, a directory
                        path (persistent, multi-process safe), or None
                        for a fresh in-memory cache
    default_timeout_s : deadline applied to submits that don't pass one
                        (None = no deadline)
    retain_done       : finished jobs kept for late `subscribe()` replay
    tracer            : obs tracer (None = ambient, True = fresh
                        recording Tracer, or a Tracer)
    clock             : monotonic time source (injectable for tests)
    device            : torch device every job scores on (default
                        "cuda"; raises here on a host without a card —
                        pass "cpu" to run on the host)
    """

    def __init__(self, *, workers: int = 2,
                 cache: Union[ResultCache, str, None] = None,
                 default_timeout_s: Optional[float] = None,
                 retain_done: int = 64,
                 tracer: Any = None,
                 clock=time.monotonic,
                 device="cuda"):
        dev = as_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        if isinstance(cache, ResultCache):
            self.cache = cache
        else:
            self.cache = ResultCache(path=cache)
        self.tracer = as_tracer(tracer)
        self.default_timeout_s = default_timeout_s
        self.retain_done = max(0, retain_done)
        self.stats = ServiceStats()
        self._clock = clock
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, workers),
            thread_name_prefix="repro-torch-dse")
        self._lock = threading.Lock()
        self._inflight: Dict[str, SearchJob] = {}
        self._retired: "OrderedDict[str, SearchJob]" = OrderedDict()
        self._n_queued = 0               # admitted, not yet running
        self._n_running = 0
        self._closed = False

    # -- admission -------------------------------------------------------
    def submit(self, query: SearchQuery, *, timeout_s: Any = _UNSET,
               sink=None) -> SearchTicket:
        """Admit a query: coalesce onto an identical in-flight job, or
        create one.  Returns immediately with a ticket; `sink` (if
        given) is subscribed as a live tap on the job stream."""
        if timeout_s is _UNSET:
            timeout_s = self.default_timeout_s
        with self.tracer.span("service.admit", strategy=query.strategy,
                              goal=query.goal) as sp:
            digest = query.digest()      # may materialize the space sig
            sp.set(digest=digest[:16])
            deadline = (None if timeout_s is None
                        else self._clock() + timeout_s)
            with self._lock:
                if self._closed:
                    raise RuntimeError("DSEService is closed")
                job = self._inflight.get(digest)
                if job is not None:
                    with self.tracer.span("service.coalesce",
                                          digest=digest[:16]):
                        self.stats.coalesced += 1
                        self.tracer.metrics.counter(
                            "service.coalesced").inc()
                        job.extend_deadline(deadline)
                        ticket = self._attach(job, coalesced=True,
                                              sink=sink)
                    sp.set(coalesced=True)
                    return ticket
                job = SearchJob(digest, query, deadline=deadline,
                                clock=self._clock)
                self._inflight[digest] = job
                self.stats.admitted += 1
                self._n_queued += 1
                self.tracer.metrics.counter("service.admitted").inc()
                self._gauges()
                ticket = self._attach(job, coalesced=False, sink=sink)
                # emitted under the service lock so `job-admitted` is
                # always event 0 — a racing coalescer can't land first
                job.emit("job-admitted", digest=digest[:16],
                              strategy=query.strategy, goal=query.goal,
                              budget=query.canonical_budget,
                              space_size=query.space_obj.size)
                self._pool.submit(self._run_job, job)
            sp.set(coalesced=False)
            return ticket

    def _attach(self, job: SearchJob, *, coalesced: bool,
                sink=None) -> SearchTicket:
        # cursor first, so a coalescing client sees its own
        # `job-coalesced` event (every subscriber sees the same stream)
        cursor = job.sink.subscribe()
        job.n_clients += 1
        if sink is not None:
            job.add_sink(sink)
        if coalesced:
            job.emit("job-coalesced", digest=job.digest[:16],
                          n_clients=job.n_clients)
        return SearchTicket(job=job, cursor=cursor, coalesced=coalesced)

    def subscribe(self, digest: str) -> Optional[SearchTicket]:
        """Pure observer attach by digest: replay-then-live on a running
        job, full replay on a retired one, None if unknown.  Does not
        count as a coalesced submit and emits nothing."""
        with self._lock:
            job = self._inflight.get(digest) or self._retired.get(digest)
            if job is None:
                return None
            return SearchTicket(job=job, cursor=job.sink.subscribe(),
                                coalesced=not job.done)

    # -- execution -------------------------------------------------------
    def _run_job(self, job: SearchJob) -> None:
        q = job.query
        with self._lock:
            self._n_queued -= 1
            self._n_running += 1
            self._gauges()
        job.status = RUNNING
        # the service tracer becomes ambient on the worker thread (context
        # variables do not cross threads), so driver phases and library
        # spans land in one buffer; the pool thread's current CUDA device
        # becomes the service's
        with activate(self.tracer), on_device(self.device), \
                self.tracer.span("service.job", digest=job.digest[:16],
                                 strategy=q.strategy, goal=q.goal,
                                 budget=q.canonical_budget) as sp:
            try:
                report = run_search(
                    q.workloads, q.space_obj, goal=q.goal,
                    strategy=q.strategy, budget=q.canonical_budget,
                    cfg=q.mapper_cfg, cache_level=q.cache_level,
                    batching=q.batching, backend=q.resolved_backend,
                    cache=self.cache, objectives=q.objectives,
                    constraints=q.cset, seed=q.seed,
                    round_size=q.round_size, overlap=q.overlap,
                    use_packed=q.use_packed,
                    strategy_params=q.strategy_params,
                    progress=job.stream, cancel=job.should_stop,
                    device=self.device)
                if report.manifest is None:
                    # cache-less services still get per-job provenance
                    report.manifest = build_manifest(
                        report, q.space_obj,
                        wall_time_s=report.wall_time_s,
                        tracer=self.tracer, device=self.device)
                self._retire(job, report=report)
            except BaseException as exc:     # noqa: BLE001 — job boundary
                self._retire(job, error=exc)
            sp.set(status=job.status)

    def _retire(self, job: SearchJob, report: Optional[SearchReport] = None,
                error: Optional[BaseException] = None) -> None:
        if report is not None:
            job._finish(report)
        else:
            job._fail(error)
        with self._lock:
            self._inflight.pop(job.digest, None)
            if self.retain_done:
                self._retired[job.digest] = job
                while len(self._retired) > self.retain_done:
                    self._retired.popitem(last=False)
            self._n_running -= 1
            if job.status == DONE:
                self.stats.completed += 1
                self.tracer.metrics.counter("service.completed").inc()
            elif job.status == CANCELLED:
                self.stats.cancelled += 1
                self.tracer.metrics.counter("service.cancelled").inc()
                if job.cancel_reason == "deadline":
                    self.stats.expired += 1
            else:
                self.stats.failed += 1
                self.tracer.metrics.counter("service.failed").inc()
            self._gauges()

    def _gauges(self) -> None:
        # called under self._lock
        self.tracer.metrics.gauge("service.queue_depth").set(
            self._n_queued)
        self.tracer.metrics.gauge("service.running").set(self._n_running)

    # -- introspection / control -----------------------------------------
    def cancel(self, digest: str, reason: str = "client") -> bool:
        """Cancel a job by digest; False if unknown or already done."""
        with self._lock:
            job = self._inflight.get(digest)
        return job.cancel(reason) if job is not None else False

    def snapshot(self) -> Dict[str, Any]:
        """ServiceStats counters plus live queue gauges."""
        with self._lock:
            d: Dict[str, Any] = self.stats.as_dict()
            d.update(queue_depth=self._n_queued,
                     running=self._n_running,
                     in_flight=len(self._inflight),
                     retained=len(self._retired))
            return d

    def close(self, *, cancel_pending: bool = False) -> None:
        """Stop admitting; optionally cancel in-flight jobs; wait for
        the pool to drain.  Idempotent."""
        with self._lock:
            self._closed = True
            jobs = list(self._inflight.values())
        if cancel_pending:
            for job in jobs:
                job.cancel("shutdown")
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "DSEService":
        return self

    def __exit__(self, *exc) -> None:
        self.close(cancel_pending=True)
