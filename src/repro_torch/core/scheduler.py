"""Whole-network scheduling over heterogeneous accelerator mixes.

A *mix* (`MixDesc`) is a tuple of `HardwareDesc` members that run
concurrently on one board — e.g. one large matmul core plus several
small ones sharing DRAM channels (the CHARM composition in ROADMAP.md).
The scheduler assigns every workload of a network — and, for training
tasks, each FW/BW/WG phase workload individually (`analyze()` already
emits one workload per phase) — to one member, then combines the
members' network estimates:

  * **cycles** — members run concurrently, so mix cycles are the max
    over members' assigned work (converted into the mix clock domain,
    the fastest member's frequency);
  * **energy / area** — sums over members (every member leaks and
    occupies silicon whether or not it is assigned work; an idle
    member simply contributes no dynamic energy);
  * **per-member accounting** — each member's own `NetworkEstimate`
    plus its utilization (busy fraction of the mix makespan).

Each member's assigned subsequence is evaluated with the *existing*
`evaluate_network` (preproc indices and activation lifetimes remapped
into the member's local schedule), so a 1-member mix is bit-identical
to the single-architecture path — the parity anchor that
tests/test_mix_parity.py pins across strategies and seeds.

Assignment selection is exact (full enumeration, lexicographically
smallest assignment wins ties) up to `exact_limit` assignments, and a
deterministic LPT greedy + single-move hill climb beyond that.  No RNG,
no wall-clock: this module is on the scoring path (R-DET).
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

from .designer import HardwareDesc
from .evaluator import NetworkEstimate, evaluate_network
from .task_analyst import TaskWorkloads
from .workload import TENSORS

#: version of the scheduler's assignment/combination semantics; part of
#: the mix cache-key signature (`search.cache._mix_sig`) so cached
#: member sub-results are invalidated when scheduling semantics change
SCHEDULER_FORMAT = 1

#: full-enumeration budget: members ** workloads at or below this is
#: solved exactly; larger instances use the deterministic greedy + hill
#: climb (the oracle tests stay well inside the exact regime)
EXACT_ASSIGNMENT_LIMIT = 4096


@dataclasses.dataclass(frozen=True)
class MixDesc:
    """A heterogeneous accelerator mix: one `HardwareDesc` per physical
    member instance (a 2x-replicated slot appears twice).  `name` is
    cosmetic (like `HardwareDesc.name`); identity is the members tuple.
    """
    name: str
    members: Tuple[HardwareDesc, ...]

    @property
    def n_members(self) -> int:
        return len(self.members)

    @property
    def frequency_hz(self) -> float:
        """The mix clock domain: the fastest member.  Mix-level cycles
        are expressed in this domain so `seconds`/`power_w` constraint
        metrics read correctly off a `MixEstimate`."""
        return max(m.frequency_hz for m in self.members)

    def total_area(self) -> float:
        """Sum of member areas — the *shared* area budget: the existing
        static constraint check (`STATIC_METRICS["area_mm2"]`) calls
        this, so an area cap rejects over-budget mixes before any
        member mapspace is built."""
        return sum(m.total_area() for m in self.members)

    def total_pes(self) -> int:
        return sum(m.total_pes() for m in self.members)


def make_mix(members: Sequence[HardwareDesc], *, name: Optional[str] = None,
             shared_bw_level: Optional[str] = None) -> MixDesc:
    """Build a `MixDesc`, optionally splitting one memory level's
    bandwidth evenly across members (`shared_bw_level="DRAM"` models a
    shared DRAM/HBM interface: each member sees 1/N of the channel via
    the existing `Level.bandwidth` model, so its mapspace is scored
    against the contended bandwidth it would actually get)."""
    members = tuple(members)
    if not members:
        raise ValueError("a mix needs at least one member")
    if shared_bw_level is not None and len(members) > 1:
        n = len(members)
        shared = []
        for hw in members:
            levels = []
            found = False
            for lv in hw.levels:
                if lv.name == shared_bw_level:
                    levels.append(dataclasses.replace(
                        lv, bandwidth=lv.bandwidth / n))
                    found = True
                else:
                    levels.append(lv)
            if not found:
                raise ValueError(
                    f"shared_bw_level {shared_bw_level!r} names no level "
                    f"of {hw.name} "
                    f"(levels: {[lv.name for lv in hw.levels]})")
            shared.append(dataclasses.replace(hw, levels=tuple(levels)))
        members = tuple(shared)
    if name is None:
        name = "mix[" + "+".join(m.name for m in members) + "]"
    return MixDesc(name=name, members=members)


@dataclasses.dataclass
class MixEstimate:
    """Mix-level analogue of `NetworkEstimate`: same metric surface
    (`cycles` / `energy_pj` / `area_mm2` / `edp` / `seconds`) so the
    Pareto objectives, constraint metrics, history rows, and progress
    events all read it unchanged — plus the per-member breakdown."""
    cycles: float                 # makespan, in the mix clock domain
    dynamic_pj: float
    static_pj: float
    cache_static_pj: float
    preproc_cycles: float         # summed over members (accounting only)
    area_mm2: float
    assignment: Tuple[int, ...]   # workload index -> member index
    #: one entry per member; None for members with no assigned work
    per_member: Tuple[Optional[NetworkEstimate], ...]
    #: each member's assigned cycles in the mix clock domain
    member_cycles: Tuple[float, ...]

    @property
    def energy_pj(self) -> float:
        return self.dynamic_pj + self.static_pj + self.cache_static_pj

    @property
    def edp(self) -> float:
        return self.cycles * self.energy_pj

    @property
    def utilization(self) -> Tuple[float, ...]:
        """Per-member busy fraction of the mix makespan."""
        if self.cycles <= 0:
            return tuple(0.0 for _ in self.member_cycles)
        return tuple(c / self.cycles for c in self.member_cycles)

    def seconds(self, mix: MixDesc) -> float:
        return self.cycles / mix.frequency_hz


@dataclasses.dataclass
class MixResult:
    """Mix-level analogue of `core.explorer.ArchResult` — what the
    search driver memoizes and the Pareto front carries for mix points.
    `per_workload` holds each workload's result *on its assigned
    member* (schedule order)."""
    hardware: MixDesc
    network: MixEstimate
    per_workload: List[object]           # WorkloadResult per workload
    #: full per-(member, workload) results the scheduler chose from
    per_member_workload: Optional[List[List[object]]] = None

    @property
    def assignment(self) -> Tuple[int, ...]:
        return self.network.assignment

    def goal_value(self, goal: str) -> float:
        if goal == "latency":
            return self.network.cycles
        if goal == "energy":
            return self.network.energy_pj
        return self.network.edp


def _goal_of(est: MixEstimate, goal: str) -> float:
    if goal == "latency":
        return est.cycles
    if goal == "energy":
        return est.energy_pj
    return est.edp


def _member_buffer_words(hw: HardwareDesc, results, cache_level: str) \
        -> float:
    """Max on-chip buffer footprint at `cache_level` over the member's
    assigned mappings — mirrors the driver's single-arch computation."""
    max_buf = 0.0
    for r in results:
        for li in hw.memory_level_indices():
            if hw.tiling_levels[li].name == cache_level:
                used = sum(r.mapping.buffer_words(li, t) for t in TENSORS)
                max_buf = max(max_buf, used)
    return max_buf


def mix_estimate_for_assignment(mix: MixDesc,
                                results_by_member: Sequence[Sequence],
                                workloads: TaskWorkloads,
                                assignment: Sequence[int],
                                cache_level: str = "Gbuf") -> MixEstimate:
    """Evaluate one layer→member assignment.

    Per member: its assigned workload subsequence (schedule order is
    preserved) goes through the existing `evaluate_network`, with
    preproc indices and activation lifetimes remapped into the member's
    local schedule — an activation lives on the member that *created*
    it, from its local creation position to the local insertion
    position of its global free point.  Mix cycles = max over members
    (converted into the mix clock domain; the conversion is skipped
    when frequencies match, keeping the 1-member path bit-identical),
    energy = sum, area = sum."""
    assignment = tuple(assignment)
    n = len(workloads.intra)
    if len(assignment) != n:
        raise ValueError(f"assignment length {len(assignment)} != "
                         f"{n} workloads")
    mix_freq = mix.frequency_hz
    per_member: List[Optional[NetworkEstimate]] = []
    member_cycles: List[float] = []
    dynamic = static = cache_static = pre_cycles = 0.0
    for mi, hw in enumerate(mix.members):
        idxs = [i for i in range(n) if assignment[i] == mi]
        if not idxs:
            per_member.append(None)
            member_cycles.append(0.0)
            continue
        local = {g: li for li, g in enumerate(idxs)}
        results = [results_by_member[mi][i] for i in idxs]
        ests = [r.estimate for r in results]
        preproc = [(local[i], p) for i, p in workloads.preproc
                   if assignment[i] == mi]
        acts = [dataclasses.replace(
                    a, created=local[a.created],
                    freed=bisect.bisect_left(idxs, a.freed))
                for a in workloads.activations
                if assignment[a.created] == mi]
        net = evaluate_network(
            hw, ests, preproc, acts, cache_level=cache_level,
            mapping_buffer_words=_member_buffer_words(
                hw, results, cache_level))
        per_member.append(net)
        ratio = mix_freq / hw.frequency_hz
        member_cycles.append(net.cycles if ratio == 1.0
                             else net.cycles * ratio)
        dynamic += net.dynamic_pj
        static += net.static_pj
        cache_static += net.cache_static_pj
        pre_cycles += net.preproc_cycles
    return MixEstimate(
        cycles=max(member_cycles),
        dynamic_pj=dynamic, static_pj=static,
        cache_static_pj=cache_static, preproc_cycles=pre_cycles,
        area_mm2=mix.total_area(), assignment=assignment,
        per_member=tuple(per_member), member_cycles=tuple(member_cycles))


def _greedy_assignment(mix: MixDesc, results_by_member, n: int) \
        -> List[int]:
    """Deterministic LPT seed: workloads in descending max-member-cost
    order, each placed on the member minimizing (resulting makespan,
    resulting energy, member index)."""
    k = len(mix.members)
    mix_freq = mix.frequency_hz
    conv = [[results_by_member[mi][i].estimate.cycles
             * (mix_freq / mix.members[mi].frequency_hz)
             for i in range(n)] for mi in range(k)]
    energy = [[results_by_member[mi][i].estimate.dynamic_pj
               + results_by_member[mi][i].estimate.static_pj
               for i in range(n)] for mi in range(k)]
    order = sorted(range(n),
                   key=lambda i: (-max(conv[mi][i] for mi in range(k)), i))
    assignment = [0] * n
    loads = [0.0] * k
    spent = [0.0] * k
    for i in order:
        best = None
        for mi in range(k):
            cand = (max(max(loads[mj] for mj in range(k) if mj != mi)
                        if k > 1 else 0.0,
                        loads[mi] + conv[mi][i]),
                    spent[mi] + energy[mi][i], mi)
            if best is None or cand < best:
                best = cand
        mi = best[2]
        assignment[i] = mi
        loads[mi] += conv[mi][i]
        spent[mi] += energy[mi][i]
    return assignment


def schedule_network(mix: MixDesc,
                     results_by_member: Sequence[Sequence],
                     workloads: TaskWorkloads,
                     cache_level: str = "Gbuf",
                     goal: str = "edp",
                     exact_limit: int = EXACT_ASSIGNMENT_LIMIT) \
        -> MixResult:
    """Choose the layer→member assignment minimizing `goal` and return
    the combined `MixResult`.

    `results_by_member[mi][wi]` is workload `wi`'s `WorkloadResult` on
    member `mi` (every workload is mapped on every member — the driver
    reuses the fused batching + result cache for those sub-jobs, so
    revisits are free).  Exact enumeration up to `exact_limit`
    assignments with a lexicographic tie-break; beyond it, an LPT
    greedy seeded hill climb (single-move improvement to a true-goal
    local optimum).  Fully deterministic either way."""
    n = len(workloads.intra)
    k = len(mix.members)
    if len(results_by_member) != k:
        raise ValueError(f"{len(results_by_member)} member result lists "
                         f"for {k} members")

    def estimate(assignment) -> MixEstimate:
        return mix_estimate_for_assignment(
            mix, results_by_member, workloads, assignment,
            cache_level=cache_level)

    if k == 1:
        best_est = estimate((0,) * n)
    elif k ** n <= exact_limit:
        best_est, best_val = None, float("inf")
        for assignment in itertools.product(range(k), repeat=n):
            est = estimate(assignment)
            val = _goal_of(est, goal)
            if val < best_val:              # strict: lexicographically
                best_est, best_val = est, val   # smallest wins ties
    else:
        assignment = _greedy_assignment(mix, results_by_member, n)
        best_est = estimate(tuple(assignment))
        best_val = _goal_of(best_est, goal)
        improved = True
        passes = 0
        while improved and passes < 4:
            improved = False
            passes += 1
            for i in range(n):
                cur = assignment[i]
                for mi in range(k):
                    if mi == cur:
                        continue
                    assignment[i] = mi
                    est = estimate(tuple(assignment))
                    val = _goal_of(est, goal)
                    if val < best_val:
                        best_est, best_val = est, val
                        cur = mi
                        improved = True
                    else:
                        assignment[i] = cur
    chosen = best_est.assignment
    per_workload = [results_by_member[chosen[i]][i] for i in range(n)]
    return MixResult(hardware=mix, network=best_est,
                     per_workload=per_workload,
                     per_member_workload=[list(r)
                                          for r in results_by_member])
