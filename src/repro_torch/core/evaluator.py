"""TRIM Evaluator (paper §6): activity analyst + performance/energy/area.

Activity math (per tensor, over its *storage chain*)
----------------------------------------------------
The storage chain of tensor t = the memory levels that stage it (levels where
the mapping does not bypass it), outermost (DRAM) first, plus the compute
leaf as terminal consumer.  For each consecutive pair (a -> b):

  V = delivery visits: flatten all temporal loops at memory levels strictly
  outer than b, in nest order; find the innermost loop relevant to t; V is
  the product of loop bounds from the outermost down to (and including) that
  loop (paper §6.1: "the product of the current loop bound and all unvisited
  loop bounds").  No relevant loop => V = 1.

  Spatial fan-out between a and b (routing levels crossed by the pair):
    per_inst tile = T(b)          (what one child instance stages)
    union tile    = T(b) x S      (S = per-dim spatial factors in (a, b));
  the parent serves the *union* once per visit (multicast data is read once,
  neighbouring instances share halos), while every child instance is filled
  with its own copy.  With N = prod(S) instances per parent instance and
  I(a) parent instances (spatial fan-out outer than a):

    parent reads  = I(a) * V * words(union)     [inputs: halo credit below]
    child fills   = I(b) * V * words(per_inst)

  * inputs: sliding-window (halo) credit — iterations of the innermost
    relevant loop, when it is E/F/R/S, fetch only the fresh portion of the
    union tile; wraps charge the full tile (paper: "compute the overlap size
    of two conjunctive iterations in each loop first").
  * outputs: read-modify-write — distinct tiles D = product of relevant loop
    bounds only; (V - D) revisits cost a partial-sum round trip
    (paper Fig. 6c discussion):
      parent writes = I(a) * V * union_out,  parent reads += I(a)*(V-D)*union_out
      child reads   = I(b) * V * per_inst_out, child writes += I(b)*(V-D)*...
  * terminal pair (last level -> PE): per_inst tile is a single word; this
    yields the register-level stationarity reuse (weight/output-stationary).

NoC words for a routing level crossed by pair (a,b): union-side words for
inputs/weights (a multicast transfer is injected once), child-side words for
outputs under accumulation (every partial crosses a link).  Spatial loop
dims classify the activity (paper §6.1): N/E/F spatial => weights multicast;
C/R/S spatial => outputs accumulated; M spatial => inputs multicast.

Performance (paper §6.2): levels are pipelined; intra-layer cycles = max of
per-level (words / (bandwidth x used instances)) and
MACs / (PEs_used * macs_per_pe * pipeline).  Zero-skipping does NOT change
time (paper §8.2.1: "without affecting throughput") — only operand-dependent
energy at/inside the zero-skip boundary.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .designer import HardwareDesc, Level
from .mapping import Mapping
from .workload import (DIMS, TENSORS, ActivationCache, PreprocWorkload,
                       Workload, E_, F_, R_, S_, N_, M_, C_)

SLIDING_DIMS = (R_, S_, E_, F_)
COMPUTE = -1  # chain terminal marker


@dataclasses.dataclass
class PairTraffic:
    tensor: str
    parent: int                 # tiling-level index
    child: int                  # tiling-level index or COMPUTE
    parent_read: float = 0.0
    parent_write: float = 0.0
    child_write: float = 0.0
    child_read: float = 0.0
    noc_words: float = 0.0      # words injected into crossed routing levels
    crosses_routing: Tuple[int, ...] = ()


@dataclasses.dataclass
class Activity:
    macs: float
    effective_macs: float
    pairs: List[PairTraffic]
    noc_unicast: float
    noc_multicast: float
    noc_accum: float
    noc_raw: float              # undiscounted words (drives NoC time)
    pes_used: int


# ---------------------------------------------------------------------------
def _flatten_temporal_loops(mapping: Mapping, below_level: int):
    """Temporal loops at memory levels strictly outer than `below_level`
    (COMPUTE => all), nest order (outer -> inner).  Yields (dim, bound)."""
    stop = below_level if below_level != COMPUTE else len(mapping.factors)
    loops = []
    for li in range(stop):
        lv = mapping.hardware.tiling_levels[li]
        if lv.kind != "memory":
            continue
        order = mapping.orders[li] or tuple(range(7))
        for d in order:
            b = mapping.factors[li][d]
            if b > 1:
                loops.append((d, b))
    return loops


def _innermost_relevant(loops, relevant) -> int:
    for i in range(len(loops) - 1, -1, -1):
        if relevant[loops[i][0]]:
            return i
    return -1


def _spatial_between(mapping: Mapping, a: int, b: int) -> Tuple[int, ...]:
    """Per-dim spatial factors of routing levels strictly between a and b."""
    hi = b if b != COMPUTE else len(mapping.factors)
    out = [1] * 7
    for r in mapping.hardware.routing_level_indices():
        if a < r < hi:
            for d in range(7):
                out[d] *= mapping.factors[r][d]
    return tuple(out)


def _inst_used(mapping: Mapping, level: int) -> int:
    """Used instances of tiling level `level` = spatial factors outer it."""
    hi = level if level != COMPUTE else len(mapping.factors)
    inst = 1
    for r in mapping.hardware.routing_level_indices():
        if r < hi:
            inst *= math.prod(mapping.factors[r])
    return inst


def _tile_of(mapping: Mapping, level: int) -> Tuple[int, ...]:
    if level == COMPUTE:
        return (1,) * 7
    return mapping.tile_dims(level)


def _fresh_input_words(wl: Workload, tile: Sequence[int],
                       slide_dim: int) -> float:
    """Fresh input words when the (union) input tile slides one step along
    `slide_dim` (one of E/F/R/S)."""
    n, m, c, r, s, e, f = tile
    p = wl.input_extent(e, r, 0)
    q = wl.input_extent(f, s, 1)
    if slide_dim == E_:
        return n * c * min(p, e * wl.stride[0]) * q
    if slide_dim == F_:
        return n * c * p * min(q, f * wl.stride[1])
    if slide_dim == R_:
        return n * c * min(p, r * wl.dilation[0]) * q
    return n * c * p * min(q, s * wl.dilation[1])


def storage_chain(mapping: Mapping, tensor: str) -> List[int]:
    """Memory levels staging `tensor`, outermost first.  DRAM (level 0)
    always stages everything."""
    chain = []
    for li in mapping.hardware.memory_level_indices():
        if li == 0 or mapping.stores(li, tensor):
            chain.append(li)
    return chain


def _pair_traffic(mapping: Mapping, tensor: str, parent: int,
                  child: int) -> PairTraffic:
    wl = mapping.workload
    per_inst = _tile_of(mapping, child)
    S = _spatial_between(mapping, parent, child)
    union = tuple(t * s for t, s in zip(per_inst, S))
    per_inst_w = wl.tile_words(tensor, per_inst)
    union_w = wl.tile_words(tensor, union)
    i_a = _inst_used(mapping, parent)
    i_b = _inst_used(mapping, child)
    crosses = tuple(r for r in mapping.hardware.routing_level_indices()
                    if parent < r < (child if child != COMPUTE
                                     else len(mapping.factors)))

    loops = _flatten_temporal_loops(mapping, child)
    rel = wl.relevance(tensor)
    k = _innermost_relevant(loops, rel)
    p = PairTraffic(tensor=tensor, parent=parent, child=child,
                    crosses_routing=crosses)
    if tensor == "output":
        if k < 0:
            v, d = 1.0, 1.0
        else:
            v = math.prod(b for _, b in loops[: k + 1])
            d = math.prod(b for dd, b in loops[: k + 1] if rel[dd])
        p.parent_write = i_a * v * union_w
        p.parent_read = i_a * (v - d) * union_w
        if child != COMPUTE:
            p.child_read = i_b * v * per_inst_w
            p.child_write = i_b * (v - d) * per_inst_w
        p.noc_words = i_b * (v + (v - d)) * per_inst_w
        return p
    # inputs / weights
    if k < 0:
        union_words = float(union_w)
    else:
        outer = math.prod(b for _, b in loops[:k])
        bk_dim, bk = loops[k]
        if tensor == "input" and bk_dim in SLIDING_DIMS and child != COMPUTE:
            fresh = _fresh_input_words(wl, union, bk_dim)
            union_words = outer * (union_w + (bk - 1) * fresh)
        else:
            union_words = outer * bk * union_w
    v = 1.0 if k < 0 else math.prod(b for _, b in loops[: k + 1])
    p.parent_read = i_a * union_words
    if child != COMPUTE:
        p.child_write = i_b * v * per_inst_w
    p.noc_words = i_a * union_words
    return p


def analyze_activity(mapping: Mapping) -> Activity:
    wl, hw = mapping.workload, mapping.hardware
    macs = float(wl.macs)
    nz = (1.0 - wl.input_zero_frac) * (
        1.0 - (wl.weight_zero_frac if wl.has_weight else 0.0))
    zs = hw.zero_skip_boundary()
    eff_macs = macs * nz if zs is not None else macs

    pairs: List[PairTraffic] = []
    tensors = ["input", "output"] + (["weight"] if wl.has_weight else [])
    for tensor in tensors:
        chain = storage_chain(mapping, tensor)
        for parent, child in zip(chain, chain[1:] + [COMPUTE]):
            pairs.append(_pair_traffic(mapping, tensor, parent, child))

    # --- NoC activity classification (paper §6.1).  Zero-skip circuits sit
    # at the zs level's read port, so skipped words never enter the NoC:
    # discount crossings whose parent is at/inside the boundary.
    noc_uni = noc_multi = noc_acc = noc_raw = 0.0
    for r in hw.routing_level_indices():
        spatial = mapping.factors[r]
        multicast_weights = any(spatial[d] > 1 for d in (N_, E_, F_))
        multicast_inputs = spatial[M_] > 1
        accum_outputs = any(spatial[d] > 1 for d in (C_, R_, S_))
        for p in pairs:
            if r not in p.crosses_routing:
                continue
            f = 1.0
            if zs is not None and p.parent >= zs and p.tensor != "output":
                f = _zs_factor(wl, p.tensor)
            w = p.noc_words * f
            noc_raw += p.noc_words
            if p.tensor == "weight":
                if multicast_weights:
                    noc_multi += w
                else:
                    noc_uni += w
            elif p.tensor == "input":
                if multicast_inputs:
                    noc_multi += w
                else:
                    noc_uni += w
            else:
                if accum_outputs:
                    noc_acc += w
                else:
                    noc_uni += w
    return Activity(macs=macs, effective_macs=eff_macs, pairs=pairs,
                    noc_unicast=noc_uni, noc_multicast=noc_multi,
                    noc_accum=noc_acc, noc_raw=noc_raw,
                    pes_used=mapping.spatial_used())


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Estimate:
    cycles: float
    dynamic_pj: float
    static_pj: float
    area_mm2: float
    level_cycles: Dict[str, float]
    level_energy_pj: Dict[str, float]
    pe_utilization: float
    buffer_utilization: Dict[str, float]
    macs: float
    effective_macs: float

    @property
    def energy_pj(self) -> float:
        return self.dynamic_pj + self.static_pj

    def seconds(self, hw: HardwareDesc) -> float:
        return self.cycles / hw.frequency_hz

    @property
    def edp(self) -> float:
        return self.cycles * self.energy_pj


def _zs_factor(wl: Workload, tensor: str) -> float:
    if tensor == "input":
        return 1.0 - wl.input_zero_frac
    if tensor == "weight":
        return 1.0 - (wl.weight_zero_frac if wl.has_weight else 0.0)
    return 1.0


def evaluate_mapping(mapping: Mapping,
                     activity: Optional[Activity] = None) -> Estimate:
    wl, hw = mapping.workload, mapping.hardware
    act = activity or analyze_activity(mapping)
    zs = hw.zero_skip_boundary()

    level_cycles: Dict[str, float] = {}
    level_energy: Dict[str, float] = {}
    buffer_util: Dict[str, float] = {}

    comp = hw.compute
    pes = max(act.pes_used, 1)
    level_cycles[comp.name] = act.macs / (pes * comp.macs_per_pe
                                          * comp.pipeline)
    level_energy[comp.name] = act.effective_macs * comp.mac_energy

    # Energy uses zero-skip-discounted words; TIME uses raw words (paper
    # §8.2.1: zero-skipping saves energy "without affecting throughput").
    reads = {li: 0.0 for li in hw.memory_level_indices()}
    writes = {li: 0.0 for li in hw.memory_level_indices()}
    raw = {li: 0.0 for li in hw.memory_level_indices()}
    for p in act.pairs:
        f = 1.0
        if zs is not None and p.parent >= zs and p.tensor != "output":
            f = _zs_factor(wl, p.tensor)
        reads[p.parent] += p.parent_read * f
        writes[p.parent] += p.parent_write * f
        raw[p.parent] += p.parent_read + p.parent_write
        if p.child != COMPUTE:
            writes[p.child] += p.child_write * f
            reads[p.child] += p.child_read * f
            raw[p.child] += p.child_write + p.child_read

    for li in hw.memory_level_indices():
        lv = hw.tiling_levels[li]
        inst = _inst_used(mapping, li)
        level_cycles[lv.name] = raw[li] / (lv.bandwidth * inst)
        level_energy[lv.name] = (reads[li] * lv.read_energy
                                 + writes[li] * lv.write_energy)
        used = sum(mapping.buffer_words(li, t) for t in TENSORS)
        cap = lv.size_words if lv.size_words else float("inf")
        buffer_util[lv.name] = used / cap if math.isfinite(cap) else 0.0

    for li in hw.routing_level_indices():
        lv = hw.tiling_levels[li]
        level_cycles[lv.name] = act.noc_raw / lv.bandwidth
        level_energy[lv.name] = (act.noc_unicast * lv.unicast_energy
                                 + act.noc_multicast * lv.multicast_energy
                                 + act.noc_accum * lv.accum_energy)

    cycles = max(level_cycles.values())
    dynamic = sum(level_energy.values())
    static = comp.pe_leak * comp.num_pes * cycles
    for li, lv in enumerate(hw.tiling_levels):
        if lv.kind == "memory":
            static += lv.leak_power * hw.instances(li) * cycles

    return Estimate(cycles=cycles, dynamic_pj=dynamic, static_pj=static,
                    area_mm2=hw.total_area(), level_cycles=level_cycles,
                    level_energy_pj=level_energy,
                    pe_utilization=act.pes_used / hw.total_pes(),
                    buffer_utilization=buffer_util, macs=act.macs,
                    effective_macs=act.effective_macs)


# ---------------------------------------------------------------------------
# Network-level evaluation (intra + inter-layer; paper §6.2 end)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class NetworkEstimate:
    cycles: float
    dynamic_pj: float
    static_pj: float
    cache_static_pj: float
    preproc_cycles: float
    area_mm2: float
    per_workload: List[Estimate]
    onchip_cached_words: float
    dram_cached_words: float

    @property
    def energy_pj(self) -> float:
        return self.dynamic_pj + self.static_pj + self.cache_static_pj

    @property
    def edp(self) -> float:
        return self.cycles * self.energy_pj

    def seconds(self, hw: HardwareDesc) -> float:
        return self.cycles / hw.frequency_hz

    @property
    def energy_per_mac_pj(self) -> float:
        macs = sum(e.macs for e in self.per_workload)
        return self.energy_pj / max(macs, 1.0)


def evaluate_network(hw: HardwareDesc, estimates: Sequence[Estimate],
                     preproc: Sequence[Tuple[int, PreprocWorkload]],
                     activations: Sequence[ActivationCache],
                     cache_level: str = "Gbuf",
                     mapping_buffer_words: float = 0.0) -> NetworkEstimate:
    """Combine per-workload optimal estimates with inter-layer workloads.

    * preprocessing: cycles = out_words / DRAM bandwidth; energy = one DRAM
      read + write per word (paper §6.2: "size of output data divided by the
      memory bandwidth").
    * activation caching: greedy — cache on-chip in `cache_level` slack if it
      fits, else DRAM (spill/refill round trip); retention (static) energy =
      words x leakage x lifetime (paper: "static energy mainly comes from
      caching the intermediate activations").  Caching time overlaps with
      compute (paper §6.2: "no extra time needed").
    """
    dram = hw.tiling_levels[0]
    intra_cycles = [e.cycles for e in estimates]
    pre_cycles = pre_pj = 0.0
    for idx, p in preproc:
        pre_cycles += p.out_words / dram.bandwidth
        pre_pj += p.out_words * (dram.read_energy + dram.write_energy)
    total_cycles = sum(intra_cycles) + pre_cycles

    starts = [0.0]
    for c in intra_cycles:
        starts.append(starts[-1] + c)

    cache_lv = next((lv for lv in hw.tiling_levels
                     if lv.name == cache_level), None)
    slack = 0.0
    leak_per_word = 0.0
    if cache_lv is not None and cache_lv.size_words is not None:
        slack = max(0.0, cache_lv.size_words - mapping_buffer_words)
        if cache_lv.size_words:
            leak_per_word = cache_lv.leak_power / cache_lv.size_words
    onchip = dram_words = cache_pj = 0.0
    for a in activations:
        lifetime = starts[min(a.freed, len(starts) - 1)] - starts[a.created]
        if a.words <= slack:
            slack -= a.words
            onchip += a.words
            cache_pj += a.words * leak_per_word * lifetime
        else:
            dram_words += a.words
            cache_pj += a.words * (dram.read_energy + dram.write_energy)

    return NetworkEstimate(
        cycles=total_cycles,
        dynamic_pj=sum(e.dynamic_pj for e in estimates) + pre_pj,
        static_pj=sum(e.static_pj for e in estimates),
        cache_static_pj=cache_pj, preproc_cycles=pre_cycles,
        area_mm2=hw.total_area(), per_workload=list(estimates),
        onchip_cached_words=onchip, dram_cached_words=dram_words)
