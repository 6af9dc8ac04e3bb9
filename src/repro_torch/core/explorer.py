"""TRIM Explorer (paper §6.3, Algorithm 1).

For each hardware description in the architecture space:
  for each intra-layer workload: build + evaluate its mapspace, keep the
  optimal mapping per the design goal; then combine optimal mappings with
  inter-layer workloads into a network-level estimate; finally select the
  optimal architecture.

Identical workloads (repeated layers) share one mapspace evaluation.
Mapspaces are scored on `device` by the oracle, or by the CUDA kernel for
the no-bypass rows (`core.backend`); each workload's winner is re-scored
by the scalar evaluator.  `explore` runs through `search.run_search` on
packed mapspaces; `find_optimal_mapping` and `evaluate_architecture`
score one architecture directly, on the object path unless `use_packed`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Union)

from ..device import as_device
from .backend import resolve_backend
from .batch_eval import batch_best_index
from .designer import HardwareDesc
from .evaluator import (Estimate, NetworkEstimate, evaluate_mapping,
                        evaluate_network)
from .mapper import MapperConfig, build_mapspace
from .mapping import Mapping
from .mapspace_array import build_packed_mapspace
from .task_analyst import TaskDescription, TaskWorkloads
from .workload import TENSORS, Workload

GOALS: Dict[str, Callable[[Estimate], float]] = {
    "latency": lambda e: e.cycles,
    "energy": lambda e: e.energy_pj,
    "edp": lambda e: e.edp,
}


@dataclasses.dataclass
class WorkloadResult:
    workload: Workload
    mapping: Mapping
    estimate: Estimate
    mapspace_size: int
    n_valid: int


@dataclasses.dataclass
class ArchResult:
    hardware: HardwareDesc
    network: NetworkEstimate
    per_workload: List[WorkloadResult]

    def goal_value(self, goal: str) -> float:
        if goal == "latency":
            return self.network.cycles
        if goal == "energy":
            return self.network.energy_pj
        return self.network.edp


@dataclasses.dataclass
class ExplorationResult:
    best: ArchResult
    all_archs: List[ArchResult]
    goal: str


def _workload_key(wl: Workload):
    return (wl.dims, wl.stride, wl.dilation, wl.kind, wl.depthwise,
            round(wl.input_zero_frac, 9), round(wl.weight_zero_frac, 9))


def _best_of_extras(extra_candidates, workload, cfg, score, best_m,
                    best_e, best_v):
    """Race caller-supplied candidate mappings against the mapspace
    winner (same goal, same evaluator); the better mapping wins.
    Candidates go through the mapper's §5 resource validator first —
    `evaluate_mapping` scores invalid mappings optimistically, so an
    unchecked warm-start could otherwise win with an infeasible tile."""
    from .mapper import validate
    for cand in (extra_candidates(workload) if extra_candidates else ()):
        if not validate(cand, cfg.act_reserve):
            continue
        e = evaluate_mapping(cand)
        v = score(e)
        if v < best_v:
            best_m, best_e, best_v = cand, e, v
    return best_m, best_e, best_v


def find_optimal_mapping(workload: Workload, hw: HardwareDesc,
                         cfg: Optional[MapperConfig] = None,
                         goal: str = "edp",
                         use_batch: bool = True,
                         backend: str = "auto",
                         use_packed: bool = False,
                         extra_candidates: Optional[
                             Callable[[Workload], Sequence[Mapping]]]
                         = None, *, device="cuda") -> WorkloadResult:
    """Search one workload's mapspace for the goal-optimal mapping.

    `backend` selects the batch scoring engine (`core.backend`): "torch"
    (the oracle), "cuda" (the kernel for the no-bypass rows) or "auto"
    (= "cuda"); both run on `device`.

    `use_packed=True` takes the array-native pipeline
    (`core.mapspace_array`): vectorized construction/validation, batch
    scoring over the packed arrays, and winner-only `Mapping`
    materialization.  The default keeps the object path (`build_mapspace`,
    with the scalar-loop selection below 64 mappings or without
    `use_batch`).  An engine that fails raises: nothing falls back to the
    scalar loop.

    `extra_candidates(workload)` may supply additional `Mapping`s (e.g. a
    warm-start carried over from a related search) that are evaluated
    against the mapspace winner; the best of all candidates is returned.
    """
    resolve_backend(backend)
    dev = as_device(device)
    cfg = cfg or MapperConfig()
    score = GOALS[goal]
    if use_packed:
        pm = build_packed_mapspace(workload, hw, cfg)
        if not len(pm):
            raise RuntimeError(
                f"empty valid mapspace for {workload.name} on {hw.name}")
        best_m = pm.materialize(batch_best_index(pm, goal, backend, dev))
        best_e = evaluate_mapping(best_m)
        best_m, best_e, _ = _best_of_extras(extra_candidates, workload,
                                            cfg, score, best_m, best_e,
                                            score(best_e))
        return WorkloadResult(workload=workload, mapping=best_m,
                              estimate=best_e,
                              mapspace_size=pm.total_candidates,
                              n_valid=pm.n_valid)
    space = build_mapspace(workload, hw, cfg)
    if not space.mappings:
        raise RuntimeError(
            f"empty valid mapspace for {workload.name} on {hw.name}")
    if use_batch and len(space.mappings) >= 64:
        best_m = space.mappings[batch_best_index(space.mappings, goal,
                                                 backend, dev)]
        best_e = evaluate_mapping(best_m)
        best_v = score(best_e)
    else:
        best_m, best_e, best_v = None, None, math.inf
        for m in space.mappings:
            e = evaluate_mapping(m)
            v = score(e)
            if v < best_v:
                best_m, best_e, best_v = m, e, v
    best_m, best_e, best_v = _best_of_extras(extra_candidates, workload,
                                             cfg, score, best_m, best_e,
                                             best_v)
    return WorkloadResult(workload=workload, mapping=best_m, estimate=best_e,
                          mapspace_size=space.total_candidates,
                          n_valid=space.n_valid)


def evaluate_architecture(task_workloads: TaskWorkloads, hw: HardwareDesc,
                          cfg: Optional[MapperConfig] = None,
                          goal: str = "edp",
                          cache_level: str = "Gbuf",
                          use_batch: bool = True,
                          backend: str = "auto",
                          use_packed: bool = False,
                          extra_candidates: Optional[
                              Callable[[Workload], Sequence[Mapping]]]
                          = None, *, device="cuda") -> ArchResult:
    """Algorithm 1 lines 6-15 for one hardware description (identical
    workloads share one `find_optimal_mapping`)."""
    cfg = cfg or MapperConfig()
    cache: Dict[tuple, WorkloadResult] = {}
    results: List[WorkloadResult] = []
    for wl in task_workloads.intra:
        key = _workload_key(wl)
        if key not in cache:
            cache[key] = find_optimal_mapping(
                wl, hw, cfg, goal, use_batch, backend, use_packed,
                extra_candidates, device=device)
        results.append(dataclasses.replace(cache[key], workload=wl))
    max_buf = 0.0
    for r in results:
        for li in hw.memory_level_indices():
            lv = hw.tiling_levels[li]
            if lv.name == cache_level:
                used = sum(r.mapping.buffer_words(li, t) for t in TENSORS)
                max_buf = max(max_buf, used)
    network = evaluate_network(
        hw, [r.estimate for r in results], task_workloads.preproc,
        task_workloads.activations, cache_level=cache_level,
        mapping_buffer_words=max_buf)
    return ArchResult(hardware=hw, network=network, per_workload=results)


def explore(task: Union[TaskDescription, TaskWorkloads],
            arch_space: Iterable[HardwareDesc],
            goal: str = "edp", cfg: Optional[MapperConfig] = None,
            cache_level: str = "Gbuf", *,
            backend: str = "auto", verbose: bool = False,
            device="cuda") -> ExplorationResult:
    """Paper Algorithm 1 — full design-space exploration.

    Thin wrapper over `repro_torch.search.run_search` with the exhaustive
    strategy and the per-(arch, workload) path on packed mapspaces: every
    architecture is evaluated in order, and the best is the first whose
    network goal value is strictly lowest (ties keep the earlier one).
    `backend` is "auto"/"cuda" (kernel for the no-bypass rows) or "torch"
    (the oracle only); both run on `device`.  `verbose` prints one line
    per architecture as it is evaluated, as the reference's does.
    """
    from ..search.driver import run_search
    report = run_search(task, list(arch_space), goal=goal, cfg=cfg,
                        cache_level=cache_level, strategy="exhaustive",
                        batching="per-arch", backend=backend,
                        verbose=verbose, device=device)
    return ExplorationResult(best=report.best, all_archs=report.all_archs,
                             goal=goal)
