"""TRIM Explorer (paper §6.3, Algorithm 1).

For each hardware description in the architecture space:
  for each intra-layer workload: build + evaluate its mapspace, keep the
  optimal mapping per the design goal; then combine optimal mappings with
  inter-layer workloads into a network-level estimate; finally select the
  optimal architecture.

Identical workloads (repeated layers) share one mapspace evaluation.
Mapspaces are packed arrays (`core.mapspace_array`), scored on `device`
through `search.batch_frontier.per_arch_best` — the oracle, or the CUDA
kernel for the no-bypass rows (`core.backend`).  Only each workload's
winner is materialized as a `Mapping` and re-scored by the scalar
evaluator.  `explore` runs through `search.run_search`;
`find_optimal_mapping` and `evaluate_architecture` score one architecture
directly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Union

from .designer import HardwareDesc
from .evaluator import Estimate, NetworkEstimate, evaluate_network
from .mapper import MapperConfig
from .mapping import Mapping
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


def _search(workloads: List[Workload], hw: HardwareDesc, cfg: MapperConfig,
            goal: str, backend: str, device) -> List[WorkloadResult]:
    """Build each workload's packed mapspace and pick its goal-best
    mapping (one `per_arch_best` job per workload)."""
    from ..search.batch_frontier import MapspaceJob, per_arch_best
    from .evaluator import evaluate_mapping
    from .mapspace_array import build_packed_mapspace
    jobs = []
    for wl in workloads:
        pm = build_packed_mapspace(wl, hw, cfg)
        if not len(pm):
            raise RuntimeError(
                f"empty valid mapspace for {wl.name} on {hw.name}")
        jobs.append(MapspaceJob(tag=wl, hw=hw, workload=wl, packed=pm))
    bests = per_arch_best(jobs, goal, device=device, backend=backend)
    out = []
    for job, b in zip(jobs, bests):
        m = job.packed.materialize(b.index)
        out.append(WorkloadResult(
            workload=job.workload, mapping=m, estimate=evaluate_mapping(m),
            mapspace_size=job.packed.total_candidates,
            n_valid=job.packed.n_valid))
    return out


def find_optimal_mapping(workload: Workload, hw: HardwareDesc,
                         cfg: Optional[MapperConfig] = None,
                         goal: str = "edp", *,
                         backend: str = "auto",
                         device="cuda") -> WorkloadResult:
    """Search one workload's mapspace for the goal-optimal mapping."""
    return _search([workload], hw, cfg or MapperConfig(), goal, backend,
                   device)[0]


def evaluate_architecture(task_workloads: TaskWorkloads, hw: HardwareDesc,
                          cfg: Optional[MapperConfig] = None,
                          goal: str = "edp",
                          cache_level: str = "Gbuf", *,
                          backend: str = "auto",
                          device="cuda") -> ArchResult:
    """Algorithm 1 lines 6-15 for one hardware description."""
    distinct: Dict[tuple, Workload] = {}
    for wl in task_workloads.intra:
        distinct.setdefault(_workload_key(wl), wl)
    found = dict(zip(distinct, _search(list(distinct.values()), hw,
                                       cfg or MapperConfig(), goal,
                                       backend, device)))
    results = [dataclasses.replace(found[_workload_key(wl)], workload=wl)
               for wl in task_workloads.intra]
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
            backend: str = "auto", device="cuda") -> ExplorationResult:
    """Paper Algorithm 1 — full design-space exploration.

    Thin wrapper over `repro_torch.search.run_search` with the exhaustive
    strategy and the per-(arch, workload) path on packed mapspaces: every
    architecture is evaluated in order, and the best is the first whose
    network goal value is strictly lowest (ties keep the earlier one).
    `backend` is "auto"/"cuda" (kernel for the no-bypass rows) or "torch"
    (the oracle only); both run on `device`.
    """
    from ..search.driver import run_search
    report = run_search(task, list(arch_space), goal=goal, cfg=cfg,
                        cache_level=cache_level, strategy="exhaustive",
                        batching="per-arch", backend=backend,
                        device=device)
    return ExplorationResult(best=report.best, all_archs=report.all_archs,
                             goal=goal)
