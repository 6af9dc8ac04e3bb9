"""Search orchestration: budgeted strategy stepping over an architecture
lattice with cached, cross-architecture-batched mapspace evaluation.

One `run_search` call is the paper's Algorithm 1 generalized three ways:

  * the outer "for each hardware description" loop becomes a pluggable
    Strategy (exhaustive / random / anneal / evolve) consuming a shared
    evaluation budget;
  * per-workload mapspace searches consult a persistent ResultCache first
    (repeated layer shapes and revisited architectures cost nothing) and
    the misses of a whole round fuse into cross-architecture
    `batch_frontier` device calls;
  * every evaluated architecture feeds a multi-objective ParetoFront in
    addition to the scalar goal ranking.

`core.explorer.explore` delegates here with strategy="exhaustive" and
batching="per-arch".

Every entry point scores on an explicit `device=` (default "cuda", which
raises on a host without a card) with the port's engines: "torch" (the
oracle), "cuda" (the mapspace kernels for no-bypass mapspaces, the oracle
for the rest) and "auto" (= "cuda").  An engine that fails raises;
nothing falls back to the oracle or to the host.

One deliberate difference from the JAX package's driver: there the
per-arch path keeps the legacy object mapspaces (`build_mapspace`) and
only `batching="fused"` builds packed ones.  Here `use_packed` (the
default) builds packed mapspaces (`build_packed_mapspace`) on both
paths — the pipeline the port's `explore` has used from the start: the
same winners at a fraction of the object pipeline's host cost — so
per-arch cache keys carry the mapspace digest and `n_packed_builds`
counts per-arch builds too.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ..core.batch_eval import score_devices
from ..core.evaluator import evaluate_network
from ..core.explorer import (ArchResult, WorkloadResult,
                             _workload_key as _wl_key)
from ..core.mapper import MapperConfig, build_mapspace
from ..core.mapspace_array import build_packed_mapspace
from ..core.evaluator import evaluate_mapping
from ..core.scheduler import MixDesc, MixResult, schedule_network
from ..core.task_analyst import TaskDescription, TaskWorkloads, analyze
from ..core.workload import TENSORS
from ..obs import (MANIFEST_DIR, ConsoleSink, ProgressStream, activate,
                   as_stream, as_tracer, build_manifest)
from ..device import as_device
from .batch_frontier import (MapspaceJob, fused_best, fused_collect,
                             fused_launch, per_arch_best)
from .cache import (ResultCache, cache_key, decode_result, encode_result,
                    mix_digest)
from .constraints import ConstraintSet
from .pareto import (DEFAULT_OBJECTIVES, ParetoFront, hypervolume,
                     objective_values, ref_from_values)
from .space import ArchSpace, Coords, as_space
from .strategies import Strategy, make_strategy


@dataclasses.dataclass
class SkippedArch:
    """An architecture rejected by a *static* constraint check (e.g. an
    area cap — `hw.total_area()` needs no mapping search), so its
    mapspaces were never built or scored.  Stands in for an ArchResult
    in the driver's memo; never joins `all_archs` or the frontier."""
    hardware: Any                        # HardwareDesc
    violation: float                     # total static relative violation

    def goal_value(self, goal: str) -> float:
        return float("inf")


@dataclasses.dataclass
class SearchReport:
    """Structured outcome of one run_search call."""
    goal: str
    strategy: str
    objectives: Tuple[str, ...]
    budget: int
    space_size: int
    best: ArchResult
    best_coords: Coords
    all_archs: List[ArchResult]          # evaluation order
    pareto: ParetoFront
    history: List[Dict[str, Any]]        # one row per *fresh* evaluation
    backend: str = "torch"               # resolved scoring engine
    overlap: bool = False                # streaming pipeline actually used
    cancelled: bool = False              # stopped early by `cancel=`
    constraints: Optional[ConstraintSet] = None
    n_evaluated: int = 0                 # distinct architectures evaluated
    n_revisits: int = 0                  # strategy re-proposals served free
    n_enumerations: int = 0              # mapspaces scored (cache misses)
    n_cache_hits: int = 0                # workload results served from cache
    n_cache_misses: int = 0
    # packed candidate-array builds (the packed pipeline derives arrays
    # even for cache hits — its keys are content digests; a warm run
    # re-builds (vectorized, ~10x cheaper than the legacy constructor)
    # but still scores nothing)
    n_packed_builds: int = 0
    n_feasible: int = 0                  # evaluations satisfying constraints
    n_skipped_infeasible: int = 0        # rejected before any scoring
    # observability (repro.obs): n_cache_hits/misses above are *derived*
    # from the cache's own CacheStats delta over this run — one source of
    # truth — and cache_stats carries the full split (memory vs disk
    # hits, puts, GC evictions) that was previously collected but buried
    wall_time_s: float = 0.0
    cache_stats: Optional[Dict[str, int]] = None
    phase_times: Dict[str, float] = dataclasses.field(default_factory=dict)
    tracer: Any = None                   # Tracer when tracing was on
    manifest: Any = None                 # RunManifest (cache-backed runs)
    manifest_path: Optional[str] = None

    def goal_value(self) -> float:
        return self.best.goal_value(self.goal)

    @property
    def feasible_frac(self) -> float:
        """Fraction of spent evaluations that were feasible designs."""
        return self.n_feasible / max(self.n_evaluated, 1)

    def best_curve(self) -> List[float]:
        """Best-so-far goal value after each fresh evaluation.  Only
        feasible rows advance the curve (their value is the raw goal;
        infeasible rows carry penalized values and are excluded from
        `best`, so the curve always ends at `goal_value()`); steps
        before the first feasible evaluation read +inf."""
        out: List[float] = []
        cur = float("inf")
        for row in self.history:
            if row.get("feasible", True):
                cur = min(cur, row["value"])
            out.append(cur)
        return out

    def hypervolume_curve(self, ref: Optional[Sequence[float]] = None) \
            -> List[float]:
        """Frontier hypervolume after each fresh evaluation (feasible
        points only — infeasible steps hold the curve flat).  With the
        default ref (worst feasible value seen across the whole run,
        `pareto.ref_from_values`) the curve is non-decreasing by
        construction; pass one explicit `ref` to compare runs."""
        if ref is None:
            vals = [row["objectives"] for row in self.history
                    if row.get("feasible", True) and row.get("objectives")]
            if not vals:
                return [0.0] * len(self.history)
            ref = ref_from_values(vals)
        front = ParetoFront(self.objectives)
        out: List[float] = []
        for row in self.history:
            if row.get("feasible", True) and row.get("objectives"):
                front.add(row["arch"], row["objectives"])
            out.append(hypervolume(front.values(), ref) if len(front)
                       else 0.0)
        return out

    def summary(self) -> Dict[str, Any]:
        snap = (self.tracer.metrics.snapshot()
                if self.tracer is not None
                and getattr(self.tracer, "enabled", False) else None)
        return {
            "goal": self.goal, "strategy": self.strategy,
            "backend": self.backend,
            "overlap": self.overlap,
            "cancelled": self.cancelled,
            "constraints": str(self.constraints) if self.constraints
            else None,
            "budget": self.budget, "space_size": self.space_size,
            "best_arch": self.best.hardware.name,
            "best_value": self.goal_value(),
            "n_evaluated": self.n_evaluated,
            "n_revisits": self.n_revisits,
            "n_enumerations": self.n_enumerations,
            "n_cache_hits": self.n_cache_hits,
            "n_cache_misses": self.n_cache_misses,
            "n_packed_builds": self.n_packed_builds,
            "n_feasible": self.n_feasible,
            "n_skipped_infeasible": self.n_skipped_infeasible,
            "feasible_frac": self.feasible_frac,
            "wall_time_s": self.wall_time_s,
            # per-run cache traffic incl. the memory/disk hit split
            "cache": self.cache_stats,
            # seconds by driver phase (empty without an active tracer);
            # matches the phase-flagged spans of the exported trace
            "phase_times": self.phase_times,
            "metrics": snap,
            "pareto_size": len(self.pareto),
            "pareto": self.pareto.summary(),
            # steps before the first feasible evaluation are +inf in
            # best_curve(); emit None so the dict stays strict-JSON-safe
            "best_curve": [v if math.isfinite(v) else None
                           for v in self.best_curve()],
            "hypervolume_curve": self.hypervolume_curve(),
        }


@dataclasses.dataclass
class _RoundPlan:
    """Everything `_Evaluator.prepare` derives from one round's fresh
    coordinates.  The streaming driver builds plans on a worker thread,
    so a plan carries its own counters and deferred progress events —
    the worker never touches the evaluator/report; the main thread folds
    a plan in via `absorb` (keeping counter updates and event order
    identical to the sequential path)."""
    batch: List[Coords]
    decoded: Dict[Tuple[Coords, str], WorkloadResult]
    # single-arch coords map to one key per workload; mix coords map to
    # one key list per *member* (List[List[str]])
    keymaps: Dict[Coords, Any]
    jobs: List[MapspaceJob]
    meta: Dict[Tuple[Coords, str], Tuple[int, int]]
    skipped: Dict[Coords, "SkippedArch"]
    survivors: List[Tuple[Coords, Any]]
    # deferred "cache-lookup" progress events (kwargs per emit), flushed
    # by `absorb` in consult order
    events: List[Dict[str, Any]]
    n_enumerations: int = 0
    n_packed_builds: int = 0
    n_rows: int = 0                      # rows this plan sends to a scorer
    n_archs_scored: int = 0              # architectures those rows cover


class _Evaluator:
    """Evaluates batches of lattice coordinates into ArchResults, with
    cache consult and (optionally) cross-arch fused scoring.

    The round is staged — prepare (host build + cache consult) / absorb
    (fold plan counters + emit deferred events) / score (device) /
    finalize (winner materialization, cache put, network assembly) — so
    the streaming driver can run `prepare` for round k+1 on a worker
    thread while round k's dispatches execute.  `__call__` composes the
    stages sequentially and is bit-identical to the pre-split evaluator.
    """

    def __init__(self, space: ArchSpace, workloads: TaskWorkloads,
                 cfg: MapperConfig, goal: str, cache_level: str,
                 use_batch: bool, batching: str, cache: ResultCache,
                 report: SearchReport, backend: str = "torch",
                 use_packed: bool = True, device="cuda",
                 constraints: Optional[ConstraintSet] = None,
                 tracer=None, stream: Optional[ProgressStream] = None):
        from ..obs import NULL_TRACER
        self.space = space
        self.workloads = workloads
        self.cfg = cfg
        self.goal = goal
        self.cache_level = cache_level
        self.use_batch = use_batch
        self.batching = batching
        self.cache = cache
        self.report = report
        self.backend = backend          # resolved engine ("torch"/"cuda")
        self.device = as_device(device)
        self.constraints = constraints
        self._cdigest = constraints.digest() if constraints else None
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.stream = stream if stream is not None else ProgressStream()
        # cache counters are derived from the cache's own stats delta
        # (CacheStats is the one source of truth; the driver used to
        # count hits/misses independently and the split was never
        # surfaced) — snapshot the baseline for this run
        self._stats0 = dataclasses.replace(cache.stats)
        # packed mapspaces on both paths (module docstring: the JAX
        # driver builds them only under batching="fused")
        self.packed = use_packed
        self.rows_scored = 0            # mapspace rows sent to a scorer
        self.archs_scored = 0           # architectures those rows covered

    def sync_cache_counters(self) -> None:
        """Fold this run's CacheStats delta into the report (hit/miss
        totals plus the memory/disk split and GC evictions)."""
        s, s0 = self.cache.stats, self._stats0
        self.report.n_cache_hits = s.hits - s0.hits
        self.report.n_cache_misses = s.misses - s0.misses
        self.report.cache_stats = {
            "hits_memory": s.hits_memory - s0.hits_memory,
            "hits_disk": s.hits_disk - s0.hits_disk,
            "misses": s.misses - s0.misses,
            "puts": s.puts - s0.puts,
            "disk_evictions": s.disk_evictions - s0.disk_evictions,
        }

    def _mapspace_and_key(self, coords: Coords, hw, wl, memo: Dict,
                          plan: _RoundPlan, mix: Optional[str] = None):
        """-> (packed_or_none, key).  The packed pipeline builds the
        arrays first (cheap, vectorized) and keys the cache on their
        content digest; the legacy pipeline keys on config alone.  For
        a mix member sub-job, `mix` carries the composition digest
        (replicated members are one object, so `id(hw)` dedupes their
        builds within the round)."""
        wk = (coords, id(hw), _wl_key(wl))
        if wk in memo:
            return memo[wk]
        if self.packed:
            pm = build_packed_mapspace(wl, hw, self.cfg)
            plan.n_packed_builds += 1
            k = cache_key(wl, hw, self.cfg, self.goal,
                          scorer=self.batching, backend=self.backend,
                          mapspace=pm.digest(),
                          constraints=self._cdigest, mix=mix)
        else:
            pm = None
            k = cache_key(wl, hw, self.cfg, self.goal,
                          scorer=self.batching, backend=self.backend,
                          constraints=self._cdigest, mix=mix)
        memo[wk] = (pm, k)
        return pm, k

    def prepare(self, batch: Sequence[Coords]) -> _RoundPlan:
        """Host side of a round: static filter, mapspace build/pack,
        cache consult.  Touches only the plan (thread-safe against a
        main thread finalizing the previous round) — progress events are
        deferred into `plan.events` and counters stay plan-local until
        `absorb`."""
        tr = self.tracer
        plan = _RoundPlan(batch=list(batch), decoded={}, keymaps={},
                          jobs=[], meta={}, skipped={}, survivors=[],
                          events=[])
        decoded, keymaps = plan.decoded, plan.keymaps
        jobs, meta = plan.jobs, plan.meta
        skipped, survivors = plan.skipped, plan.survivors
        ms_memo: Dict[object, Tuple[object, str]] = {}
        # pass 1a: static constraint filter on the hardware description
        # alone — rejected designs never build, pack, or score a mapspace
        with tr.span("static-filter", phase=True, archs=len(batch)) as sp:
            for coords in batch:
                hw = self.space.at(coords)
                if self.constraints is not None \
                        and self.constraints.statically_infeasible(hw):
                    skipped[coords] = SkippedArch(
                        hardware=hw,
                        violation=self.constraints.static_violation(hw))
                    continue
                survivors.append((coords, hw))
            sp.set(skipped=len(skipped))

        # pass 1b: cache consult (pack/validate spans come from the
        # mapspace build functions); collect mapspace jobs for the misses.  A
        # MixDesc point fans out into per-(member, workload) sub-jobs
        # that ride the same tag-dedupe, cache, and fused batching —
        # identical replicated members share jobs via identical keys.
        for coords, hw in survivors:
            if isinstance(hw, MixDesc):
                mdig = mix_digest(hw)
                keymaps[coords] = [
                    self._consult_unit(coords, member, ms_memo, plan,
                                       mix=mdig)
                    for member in hw.members]
            else:
                keymaps[coords] = self._consult_unit(coords, hw,
                                                     ms_memo, plan)

        plan.n_rows = sum(j.n_rows() for j in jobs)
        # only architectures that actually contributed jobs — counting
        # fully-cache-served archs would skew mean rows/arch low and
        # inflate the auto round size
        plan.n_archs_scored = len({j.tag[0] for j in jobs})
        return plan

    def _consult_unit(self, coords: Coords, hw, ms_memo: Dict,
                      plan: _RoundPlan,
                      mix: Optional[str] = None) -> List[str]:
        """Cache consult + job collection for one hardware unit (a
        single arch, or one member of a mix) over every workload;
        -> the unit's per-workload cache keys."""
        tr = self.tracer
        decoded, jobs, meta = plan.decoded, plan.jobs, plan.meta
        keys: List[str] = []
        for wl in self.workloads.intra:
            pm, k = self._mapspace_and_key(coords, hw, wl, ms_memo,
                                           plan, mix=mix)
            keys.append(k)
            tag = (coords, k)
            if tag in decoded or tag in meta:
                continue                # repeated layer within this arch
            with tr.span("cache-get", phase=True) as cs:
                entry = self.cache.get(k)
                if entry is not None:
                    decoded[tag] = decode_result(entry, wl, hw)
                    cs.set(hit=True)
            if entry is not None:
                if self.stream.active:
                    plan.events.append(dict(hit=True, arch=hw.name,
                                            workload=wl.name))
                continue
            if self.stream.active:
                plan.events.append(dict(hit=False, arch=hw.name,
                                        workload=wl.name))
            plan.n_enumerations += 1
            if pm is not None:
                if not len(pm):
                    raise RuntimeError(
                        f"empty valid mapspace for {wl.name} "
                        f"on {hw.name}")
                jobs.append(MapspaceJob(tag=tag, hw=hw, workload=wl,
                                        packed=pm))
                meta[tag] = (pm.total_candidates, pm.n_valid)
            else:
                space_ = build_mapspace(wl, hw, self.cfg)
                if not space_.mappings:
                    raise RuntimeError(
                        f"empty valid mapspace for {wl.name} "
                        f"on {hw.name}")
                jobs.append(MapspaceJob(tag=tag, hw=hw, workload=wl,
                                        mappings=space_.mappings))
                meta[tag] = (space_.total_candidates, space_.n_valid)
        return keys

    def absorb(self, plan: _RoundPlan) -> None:
        """Fold a plan's counters into the report and flush its deferred
        progress events (main thread only — the one writer of report and
        evaluator state)."""
        for kw in plan.events:
            self.stream.emit("cache-lookup", **kw)
        plan.events = []
        self.report.n_enumerations += plan.n_enumerations
        self.report.n_packed_builds += plan.n_packed_builds
        if plan.jobs:
            self.tracer.metrics.counter("search.rows_scored") \
                .inc(plan.n_rows)
            self.rows_scored += plan.n_rows
            self.archs_scored += plan.n_archs_scored

    def score_sync(self, plan: _RoundPlan) -> List[Any]:
        """Pass 2, synchronous: score all pending mapspaces (fused
        across architectures, or one call per job)."""
        if not plan.jobs:
            return []
        jobs = plan.jobs
        with self.tracer.span("score", phase=True, jobs=len(jobs),
                              rows=plan.n_rows, scorer=self.batching,
                              backend=self.backend):
            if self.batching == "fused":
                bests = fused_best(jobs, self.goal, device=self.device,
                                   backend=self.backend)
            else:
                bests = per_arch_best(jobs, self.goal, self.use_batch,
                                      device=self.device,
                                      backend=self.backend)
        return bests

    def launch(self, plan: _RoundPlan):
        """Pass 2, streaming: issue every fused dispatch of the round
        without waiting for it (the host is free to build the next round
        while the device works).  The "score" span holds the host-side
        prep + enqueue time; the wait lands in `collect`'s "device-wait"
        span."""
        if not plan.jobs:
            return None
        with self.tracer.span("score", phase=True, jobs=len(plan.jobs),
                              rows=plan.n_rows, scorer=self.batching,
                              backend=self.backend, deferred=True):
            pending = fused_launch(plan.jobs, self.goal,
                                   device=self.device,
                                   backend=self.backend)
        return pending

    def collect(self, plan: _RoundPlan, pending) -> List[Any]:
        """Wait for the round's in-flight device scores -> JobBest list."""
        if pending is None:
            return []
        with self.tracer.span("device-wait", phase=True,
                              jobs=len(plan.jobs), rows=plan.n_rows):
            return fused_collect(pending)

    def finalize(self, plan: _RoundPlan, bests: List[Any]) \
            -> Dict[Coords, Union[ArchResult, SkippedArch]]:
        """Pass 3: winner materialization + cache put, then
        network-level assembly per architecture (Algorithm 1 lines
        12-14; mirrors core.explorer.evaluate_architecture)."""
        tr = self.tracer
        decoded, jobs, meta = plan.decoded, plan.jobs, plan.meta
        if jobs:
            with tr.span("cache-put", phase=True, jobs=len(jobs)):
                for job, b in zip(jobs, bests):
                    # winner-only materialization: the packed pipeline
                    # never builds Mapping objects for the losers
                    m = (job.packed.materialize(b.index)
                         if job.packed is not None
                         else job.mappings[b.index])
                    est = evaluate_mapping(m)
                    total, n_valid = meta[job.tag]
                    r = WorkloadResult(workload=job.workload, mapping=m,
                                       estimate=est, mapspace_size=total,
                                       n_valid=n_valid)
                    decoded[job.tag] = r
                    self.cache.put(job.tag[1], encode_result(r))

        out: Dict[Coords, ArchResult] = {}
        out.update(plan.skipped)
        with tr.span("assemble", phase=True,
                     archs=len(plan.survivors)):
            for coords, hw in plan.survivors:
                if isinstance(hw, MixDesc):
                    # every workload was mapped on every member; the
                    # scheduler picks the layer->member assignment and
                    # combines per-member networks (max cycles, summed
                    # energy/area)
                    results_by_member = [
                        [dataclasses.replace(decoded[(coords, k)],
                                             workload=wl)
                         for wl, k in zip(self.workloads.intra, keys)]
                        for keys in plan.keymaps[coords]]
                    out[coords] = schedule_network(
                        hw, results_by_member, self.workloads,
                        cache_level=self.cache_level, goal=self.goal)
                    continue
                results = [
                    dataclasses.replace(decoded[(coords, k)], workload=wl)
                    for wl, k in zip(self.workloads.intra,
                                     plan.keymaps[coords])]
                max_buf = 0.0
                for r in results:
                    for li in hw.memory_level_indices():
                        if hw.tiling_levels[li].name == self.cache_level:
                            used = sum(r.mapping.buffer_words(li, t)
                                       for t in TENSORS)
                            max_buf = max(max_buf, used)
                network = evaluate_network(
                    hw, [r.estimate for r in results],
                    self.workloads.preproc, self.workloads.activations,
                    cache_level=self.cache_level,
                    mapping_buffer_words=max_buf)
                out[coords] = ArchResult(hardware=hw, network=network,
                                         per_workload=results)
        self.sync_cache_counters()
        return out

    def __call__(self, batch: Sequence[Coords]) \
            -> Dict[Coords, Union[ArchResult, SkippedArch]]:
        plan = self.prepare(batch)
        self.absorb(plan)
        return self.finalize(plan, self.score_sync(plan))


TARGET_FUSED_ROWS = 65536       # rows one auto-sized round aims to fuse
AUTO_ROUND_MIN = 2
AUTO_ROUND_MAX = 64


def auto_round_size(mean_rows_per_arch: float,
                    n_devices: Optional[int] = None) -> Optional[int]:
    """`round_size="auto"`: fuse bigger rounds when mapspaces are small
    (per-round overhead amortizes over more architectures) and smaller
    rounds when they are large (bounds one fused group's rows).  Returns
    None when there is no signal yet (all cache hits).

    The row target and round cap were tuned against one device; with
    `n_devices` devices a fused group shards row-wise across all of them
    (`batch_frontier._shard_plan`), so both scale linearly.  The default
    is the shard plan's device count for a CUDA run (the host's CUDA
    devices, at least one); `run_search` passes its scoring device's."""
    if mean_rows_per_arch <= 0:
        return None
    if n_devices is None:
        import torch
        n_devices = torch.cuda.device_count()
    n_devices = max(1, int(n_devices))
    return max(AUTO_ROUND_MIN,
               min(AUTO_ROUND_MAX * n_devices,
                   (TARGET_FUSED_ROWS * n_devices)
                   // max(1, int(mean_rows_per_arch))))


def run_search(task: Union[TaskDescription, TaskWorkloads],
               arch_space,
               goal: str = "edp",
               strategy: Union[str, Strategy] = "exhaustive",
               budget: Optional[int] = None,
               cfg: Optional[MapperConfig] = None,
               cache_level: str = "Gbuf",
               use_batch: bool = True,
               batching: str = "fused",
               backend: str = "auto",
               cache: Union[ResultCache, str, None] = None,
               objectives: Sequence[str] = DEFAULT_OBJECTIVES,
               constraints=None,
               seed: int = 0,
               round_size: Union[int, str] = 8,
               overlap: Union[str, bool] = "auto",
               use_packed: bool = True,
               strategy_params: Optional[Dict[str, Any]] = None,
               trace: Union[None, bool, Any] = None,
               progress: Any = None,
               cancel: Any = None,
               verbose: bool = False,
               device="cuda") -> SearchReport:
    """Multi-strategy, multi-objective design-space exploration.

    task       : TaskDescription (analyzed here) or pre-built TaskWorkloads
    arch_space : ArchSpace lattice or iterable of HardwareDesc
    strategy   : registry name (exhaustive|random|anneal|evolve) or instance
    budget     : max distinct architecture evaluations (default: lattice
                 size — exhaustive coverage)
    batching   : "fused" packs a round's mapspaces into cross-architecture
                 scoring calls (one multi-architecture kernel launch per
                 BatchSig group of no-bypass mapspaces under "cuda");
                 "per-arch" keeps the explorer's one-call-per-(arch,
                 workload) path
    backend    : mapspace scoring engine (`core.backend`): "torch"
                 (oracle), "cuda" (kernels/mapspace_eval for the
                 no-bypass rows, the oracle for the rest; on a CPU device
                 the kernel's plain version), or "auto" (= "cuda").
                 Participates in the result-cache key, so torch- and
                 cuda-scored entries never alias.  An engine that fails
                 raises.
    device     : torch device every scoring call runs on (default
                 "cuda"; raises on a host without a card — pass "cpu" to
                 run on the host).
    cache      : ResultCache, a directory path for a persistent cache, or
                 None for a fresh in-memory cache
    constraints: hardware budgets (`search.constraints`): a ConstraintSet,
                 a Constraint, a "metric<=bound" string, or a list of
                 either.  Only feasible designs join the frontier and the
                 best ranking; strategies receive penalized feedback for
                 infeasible ones; designs violating a *static* constraint
                 (area cap) are rejected before any mapspace is built or
                 scored.  The constraint digest joins the cache key, so
                 constrained and unconstrained entries never alias.
    round_size : architectures proposed per strategy round; "auto" scales
                 each round to the observed mean mapspace size (small
                 mapspaces -> bigger fused rounds, large -> smaller)
    overlap    : streaming pipeline — overlap round k's device execution
                 with round k+1's host-side build.  "auto" (default)
                 streams whenever `batching="fused"` and the strategy
                 declares `lookahead = True` (exhaustive/random: `ask`
                 is independent of `tell`); True asks for streaming but
                 still degrades to the synchronous loop for adaptive
                 strategies (anneal/evolve/bandit/hv-evolve need round
                 k's feedback before proposing k+1) or per-arch
                 batching; False forces the synchronous loop.  Winners,
                 history, and frontier are bit-identical either way —
                 streaming never changes *what* is evaluated, only when
                 the host blocks.  Streaming runs with async disk-cache
                 writeback (drained before the search returns) and adds
                 "prefetch-build" / "device-wait" / "cache-flush" phases
                 to the trace.  `report.overlap` records the resolved
                 mode.
    use_packed : drive both paths with `PackedMapspace` arrays
                 (vectorized construction/validation, winner-only
                 materialization, content-digest cache keys); False keeps
                 the object pipeline (`build_mapspace`; identical
                 winners)
    trace      : observability (`repro_torch.obs`): None inherits the
                 ambient
                 tracer (a no-op unless `obs.activate` scoped one), True
                 records into a fresh `Tracer` (returned as
                 `report.tracer`), False forces tracing off, or pass a
                 `Tracer`.  Spans are host-side only; per-round phases
                 (propose / static-filter / pack / validate / score /
                 cache-get / cache-put / assemble / frontier-update,
                 plus prefetch-build / device-wait / cache-flush under
                 streaming) land in `report.phase_times` and the
                 Chrome/JSONL exports.  The default is zero-overhead.
    progress   : a ProgressStream, sink callable, or list of sinks fed
                 typed `ProgressEvent`s (arch evaluated/skipped, cache
                 lookups, frontier growth, round completion) — the
                 streaming channel for a DSE service.  `verbose=True`
                 subscribes the ConsoleSink (historical print format).
    cancel     : cooperative cancellation — a `threading.Event` (or any
                 object with `is_set()`), or a zero-arg callable
                 returning True to stop.  Checked once per round at the
                 propose boundary (both loops route through the same
                 choke point), so a fired cancel lets the in-flight
                 round complete cleanly and the search returns a
                 *partial* but fully consistent report —
                 `report.cancelled=True`, frontier/history/best cover
                 every finished round.  Cancelling before the first
                 round completes raises (there is no best yet).
    """
    from ..core.backend import resolve_backend
    if batching not in ("fused", "per-arch"):
        raise ValueError(f"batching must be 'fused' or 'per-arch', "
                         f"got {batching!r}")
    if overlap not in ("auto", True, False):
        raise ValueError(f"overlap must be 'auto', True, or False, "
                         f"got {overlap!r}")
    auto_round = round_size == "auto"
    if not auto_round and (not isinstance(round_size, int)
                           or round_size < 1):
        raise ValueError(f"round_size must be a positive int or 'auto', "
                         f"got {round_size!r}")
    backend = resolve_backend(backend)
    dev = as_device(device)
    n_devices = len(score_devices(dev))     # the fused shard plan's
    cset = ConstraintSet.from_any(constraints)
    space = as_space(arch_space)
    workloads = task if isinstance(task, TaskWorkloads) else analyze(task)
    cfg = cfg or MapperConfig()
    if isinstance(cache, str):
        cache = ResultCache(path=cache)
    elif cache is None:
        cache = ResultCache()
    strat = strategy if isinstance(strategy, Strategy) else make_strategy(
        strategy, space, seed=seed, **(strategy_params or {}))
    # budget counts *distinct* architecture evaluations, so it can never
    # exceed the lattice; clamping also stops never-exhausted strategies
    # (anneal/evolve) from spinning on revisits once everything is memoized
    budget = space.size if budget is None else max(1, min(budget,
                                                          space.size))
    if cancel is None:
        cancel_fn = None
    elif hasattr(cancel, "is_set"):
        cancel_fn = cancel.is_set       # threading.Event & friends
    elif callable(cancel):
        cancel_fn = cancel
    else:
        raise TypeError(f"cancel must be an Event-like (is_set) or a "
                        f"zero-arg callable, got {type(cancel).__name__}")

    tracer = as_tracer(trace)
    stream = as_stream(progress)
    if verbose:
        # the historical verbose=True output, now one code path: a
        # console sink rendering the per-architecture progress events
        stream.subscribe(ConsoleSink())

    report = SearchReport(goal=goal, strategy=strat.name,
                          objectives=tuple(objectives), budget=budget,
                          space_size=space.size, best=None,   # type: ignore
                          best_coords=(), all_archs=[],
                          pareto=ParetoFront(objectives), history=[],
                          backend=backend, constraints=cset,
                          tracer=tracer if tracer.enabled else None)
    evaluate = _Evaluator(space, workloads, cfg, goal, cache_level,
                          use_batch, batching, cache, report,
                          backend=backend, use_packed=use_packed,
                          device=dev, constraints=cset, tracer=tracer,
                          stream=stream)

    # duck-typed: pre-registry Strategy objects may predate the hooks
    _observe = getattr(strat, "observe", lambda c, o, f=True: None)
    if cset is not None:
        # strategies that understand budgets repair their own proposals
        # against the static constraints (never wasting budget on e.g.
        # over-area designs); the evaluator still rejects any that slip
        getattr(strat, "set_constraints", lambda c: None)(cset)

    # streaming (tentpole): overlap round k's device execution with round
    # k+1's host build.  Only safe when proposals cannot depend on
    # pending feedback — the strategy must declare `lookahead = True` —
    # and only useful on the fused path (per-arch scoring forces per job).
    lookahead = bool(getattr(strat, "lookahead", False))
    use_stream = (overlap is not False and batching == "fused"
                  and lookahead)
    report.overlap = use_stream

    memo: Dict[Coords, Union[ArchResult, SkippedArch]] = {}
    best: Optional[ArchResult] = None
    best_coords: Coords = ()
    best_val = float("inf")

    cur_round = 8 if auto_round else round_size
    stall_rounds = 0
    n_rounds = 0
    # `planned` counts fresh coordinates committed to a round plan; it
    # reaches the same value report.n_evaluated eventually does, but is
    # current *at propose time* even when a round's bookkeeping has not
    # landed yet (streaming proposes k+1 before finishing k).  `seen`
    # likewise fronts for `memo` in the freshness check.
    planned = 0
    seen: set = set()
    rounds_proposed = 0
    t_begin = time.perf_counter()

    def try_propose() -> Optional[Tuple[List[Coords], List[Coords]]]:
        """One strategy ask + dedup -> (ordered, fresh), or None when
        the search is over (budget spent, lattice exhausted, strategy
        done or stalled).  Identical proposal sequence in both loops:
        all inputs (`planned`, `seen`, `cur_round`) are current at the
        equivalent sequential point."""
        nonlocal rounds_proposed, stall_rounds, planned
        if cancel_fn is not None and cancel_fn():
            # cooperative cancellation: both loops call try_propose at
            # the round boundary, so stopping here never abandons an
            # in-flight round — the report stays internally consistent
            report.cancelled = True
            return None
        if planned >= budget or strat.exhausted:
            return None
        if len(seen) >= space.size or stall_rounds >= 100:
            return None                 # nothing fresh left to evaluate
        want = min(cur_round, budget - planned)
        with tracer.span("propose", phase=True, round=rounds_proposed,
                         want=want) as psp:
            proposals = strat.ask(want)
            seen_round = set()
            ordered: List[Coords] = []
            for c in proposals:
                c = tuple(c)
                if c not in seen_round:
                    seen_round.add(c)
                    ordered.append(c)
            fresh = [c for c in ordered
                     if c not in memo and c not in seen]
            psp.set(proposed=len(ordered), fresh=len(fresh))
        rounds_proposed += 1
        if not proposals:
            return None                 # strategy is awaiting nothing: stop
        stall_rounds = 0 if fresh else stall_rounds + 1
        planned += len(fresh)
        seen.update(fresh)
        return ordered, fresh

    def resize() -> None:
        """`round_size="auto"` update from the observed mean mapspace
        size (reads prepare-time counters, so both loops see identical
        values at the equivalent point)."""
        nonlocal cur_round
        if auto_round and evaluate.archs_scored:
            sized = auto_round_size(evaluate.rows_scored
                                    / evaluate.archs_scored, n_devices)
            if sized is not None:
                cur_round = sized

    def finish_round(ordered: List[Coords],
                     fresh: List[Coords]) -> None:
        """Frontier/history/feedback bookkeeping for one completed
        round (shared verbatim by the sequential and streaming loops,
        always in round order)."""
        nonlocal best, best_coords, best_val, n_rounds
        feedback: List[Tuple[Coords, float]] = []
        fresh_set = set(fresh)
        with tracer.span("frontier-update", phase=True,
                         round=n_rounds):
            for c in ordered:
                res = memo[c]
                if isinstance(res, SkippedArch):
                    # statically rejected: the strategy still learns
                    # (ordered by violation), but nothing joins
                    # frontier/all_archs
                    val = cset.skip_value(res.violation)
                    feedback.append((c, val))
                    if c in fresh_set:
                        report.n_evaluated += 1
                        report.n_skipped_infeasible += 1
                        report.history.append({
                            "step": report.n_evaluated, "coords": c,
                            "arch": res.hardware.name, "value": val,
                            "objectives": None, "feasible": False,
                            "skipped": True})
                        _observe(c, None, False)
                        stream.emit("arch-skipped",
                                    arch=res.hardware.name,
                                    violation=res.violation,
                                    step=report.n_evaluated)
                    else:
                        report.n_revisits += 1
                    continue
                raw = res.goal_value(goal)
                obj_vals = objective_values(res.network,
                                            report.objectives)
                if cset is None:
                    feasible, val = True, raw
                else:
                    violation = cset.violation(res.network,
                                               res.hardware)
                    feasible = violation <= 0.0
                    val = raw if feasible \
                        else cset.penalized(raw, violation)
                feedback.append((c, val))
                if c in fresh_set:
                    report.n_evaluated += 1
                    report.all_archs.append(res)
                    row_extra = {}
                    if isinstance(res, MixResult):
                        # mix-aware rows: the composition and the
                        # scheduler's chosen layer->member assignment
                        # land in the report (and the bench claim)
                        row_extra = {
                            "members": [m.name
                                        for m in res.hardware.members],
                            "assignment": list(res.assignment),
                            "utilization": list(
                                res.network.utilization)}
                    if feasible:
                        report.n_feasible += 1
                        front_n = len(report.pareto)
                        report.pareto.add_network(res.hardware.name,
                                                  res.network,
                                                  payload=res)
                        if len(report.pareto) > front_n:
                            stream.emit(
                                "frontier-grew",
                                arch=res.hardware.name,
                                size=len(report.pareto),
                                step=report.n_evaluated)
                        if best is None or raw < best_val:
                            best, best_coords, best_val = res, c, raw
                    report.history.append({
                        "step": report.n_evaluated, "coords": c,
                        "arch": res.hardware.name, "value": val,
                        "objectives": obj_vals, "feasible": feasible,
                        **row_extra})
                    _observe(c, obj_vals, feasible)
                    n = res.network
                    stream.emit("arch-evaluated",
                                arch=res.hardware.name,
                                cycles=n.cycles,
                                energy_pj=n.energy_pj, edp=n.edp,
                                value=val, feasible=feasible,
                                step=report.n_evaluated)
                else:
                    report.n_revisits += 1
            strat.tell(feedback)
        n_rounds += 1
        stream.emit("round-finished", round=n_rounds,
                    n_evaluated=report.n_evaluated,
                    n_fresh=len(fresh),
                    best_value=(best_val if best is not None
                                else None),
                    pareto_size=len(report.pareto))

    # streaming runs with the cache's bounded async disk writeback: the
    # memory tier and stats stay synchronous (deterministic reads), only
    # the fsync-ish tail leaves the hot loop.  Drained before return.
    writer_on = bool(use_stream and cache.path)

    # the tracer becomes ambient for the whole search, so instrumented
    # library code (mapper, backend, batch_frontier, cache) records into
    # it without parameter plumbing; all spans are host-side only
    with activate(tracer), tracer.span("run_search", strategy=strat.name,
                                       backend=backend, goal=goal,
                                       budget=budget,
                                       space_size=space.size,
                                       overlap=use_stream):
        if writer_on:
            cache.start_async_writes()
        try:
            if not use_stream:
                while True:
                    p = try_propose()
                    if p is None:
                        break
                    ordered, fresh = p
                    if fresh:
                        memo.update(evaluate(fresh))
                        resize()
                    finish_round(ordered, fresh)
            else:
                import concurrent.futures

                def _prepare_bg(batch):
                    # contextvars do not cross threads: re-activate the
                    # ambient tracer so pack/validate/cache-get spans
                    # from the worker land in the same buffer
                    with activate(tracer):
                        return evaluate.prepare(batch)

                pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1,
                    thread_name_prefix="repro-torch-prefetch")
                try:
                    # bootstrap: round 0 is proposed and prepared on the
                    # main thread (there is nothing to overlap with yet)
                    ready = None
                    p = try_propose()
                    if p is not None:
                        ordered, fresh = p
                        plan = (evaluate.prepare(fresh) if fresh
                                else None)
                        if plan is not None:
                            evaluate.absorb(plan)
                            resize()
                        ready = (ordered, fresh, plan)
                    while ready is not None:
                        ordered, fresh, plan = ready
                        # propose k+1 (lookahead contract: ask is
                        # independent of round k's pending tell) and
                        # hand its host build to the worker *before*
                        # launching round k, so the build overlaps both
                        # dispatch/compile and device execution
                        nxt = try_propose()
                        fut = (pool.submit(_prepare_bg, nxt[1])
                               if nxt is not None and nxt[1] else None)
                        if plan is not None:
                            pending = evaluate.launch(plan)
                            bests = evaluate.collect(plan, pending)
                            memo.update(evaluate.finalize(plan, bests))
                        finish_round(ordered, fresh)
                        if nxt is None:
                            ready = None
                            continue
                        ordered2, fresh2 = nxt
                        plan2 = None
                        if fut is not None:
                            # any build time not already hidden under
                            # round k shows up here, making the residual
                            # (non-overlapped) cost visible in the trace
                            with tracer.span("prefetch-build",
                                             phase=True,
                                             archs=len(fresh2)):
                                plan2 = fut.result()
                        if plan2 is not None:
                            evaluate.absorb(plan2)
                            resize()
                        ready = (ordered2, fresh2, plan2)
                finally:
                    pool.shutdown(wait=True)
            if writer_on:
                # drain inside the traced region so flush cost is a
                # phase, not anonymous tail time
                with tracer.span("cache-flush", phase=True):
                    cache.stop_async_writes()
                errs = cache.writer_errors
                if errs:
                    raise RuntimeError(
                        f"async cache writeback failed: {errs[0]!r}")
        finally:
            if writer_on:
                # exception path: still drain (completed puts must land;
                # idempotent after the traced flush above)
                cache.stop_async_writes()

    evaluate.sync_cache_counters()
    report.wall_time_s = time.perf_counter() - t_begin
    if tracer.enabled:
        report.phase_times = tracer.phase_times()
        tracer.metrics.counter("search.rounds").inc(n_rounds)
    if best is None:
        if report.cancelled:
            raise RuntimeError(
                "search cancelled before any feasible architecture "
                "completed a round — no partial result to return")
        if cset is not None:
            raise RuntimeError(
                f"no feasible architecture under {cset} "
                f"({report.n_evaluated} evaluated, "
                f"{report.n_skipped_infeasible} statically rejected); "
                f"relax the constraints or widen the space")
        raise RuntimeError("search evaluated no architectures "
                           "(empty space or zero budget)")
    report.best = best
    report.best_coords = best_coords
    stream.emit("search-finished", n_evaluated=report.n_evaluated,
                best_arch=report.best.hardware.name,
                best_value=report.goal_value(),
                wall_time_s=report.wall_time_s)
    # provenance manifest, written alongside the cached results so any
    # disk-cache entry can be attributed to the run that produced it
    if cache.path:
        report.manifest = build_manifest(
            report, space, wall_time_s=report.wall_time_s, tracer=tracer,
            device=dev)
        report.manifest_path = report.manifest.write(
            os.path.join(cache.path, MANIFEST_DIR))
    elif tracer.enabled:
        report.manifest = build_manifest(
            report, space, wall_time_s=report.wall_time_s, tracer=tracer,
            device=dev)
    return report
