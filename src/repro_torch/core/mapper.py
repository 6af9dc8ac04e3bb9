"""TRIM Mapper (paper §5): mapping constructor, validator, mapspace pruner.

The constructor factorizes each workload loop bound across the tiling levels
(paper: "the Cartesian product of the cofactor sets for each dimension"),
enumerates loop orders per memory level and bypass choices — a space of size
(cofactor products) x (7!)^N x (2^N)^3, "in the trillions".  We therefore:

  * enumerate ordered factorizations exactly, but sample the cartesian
    product deterministically when it exceeds the budget;
  * use a representative loop-order set per level (stationarity classes:
    output/weight/input-stationary + row-stationary-like) plus optional
    seeded random orders — `orders="exhaustive"` enables all 5040 for tiny
    studies;
  * validate buffer capacities (incl. reserved inter-layer activation words,
    paper §5) and spatial fan-out;
  * prune with the paper's two utilization constraints (§5.2): PE
    utilization >= 0.75 when the goal is throughput, innermost-memory
    utilization >= 0.5 when the goal is energy.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import random
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .designer import HardwareDesc
from .mapping import Mapping
from .workload import DIMS, TENSORS, Workload, N_, M_, C_, R_, S_, E_, F_

# -- loop-order templates ---------------------------------------------------
# Outermost-first permutations of dim indices (N,M,C,R,S,E,F).
REPRESENTATIVE_ORDERS: Tuple[Tuple[int, ...], ...] = (
    (N_, M_, C_, R_, S_, E_, F_),   # canonical (paper Fig. 3)
    (N_, E_, F_, M_, C_, R_, S_),   # output-stationary (reduction innermost)
    (C_, R_, S_, N_, M_, E_, F_),   # reduction outermost
    (N_, C_, E_, F_, M_, R_, S_),
    (M_, C_, R_, S_, N_, E_, F_),   # weight-stationary (W dims outer)
    (N_, E_, F_, C_, M_, R_, S_),
    (N_, C_, F_, E_, S_, R_, M_),   # input-stationary-ish (M innermost)
    (M_, N_, E_, F_, C_, R_, S_),
    (C_, M_, N_, R_, S_, E_, F_),
    (E_, F_, N_, M_, C_, R_, S_),
    (N_, M_, E_, C_, R_, S_, F_),   # row-stationary-like (S/F inner)
    (M_, E_, N_, C_, R_, F_, S_),
)


def _divisors(x: int) -> List[int]:
    out = []
    i = 1
    while i * i <= x:
        if x % i == 0:
            out.append(i)
            if i != x // i:
                out.append(x // i)
        i += 1
    return sorted(out)


def ordered_factorizations(bound: int, levels: int) -> List[Tuple[int, ...]]:
    """All tuples (f_0..f_{levels-1}) with product == bound."""
    if levels == 1:
        return [(bound,)]
    out = []
    for d in _divisors(bound):
        for rest in ordered_factorizations(bound // d, levels - 1):
            out.append((d,) + rest)
    return out


@dataclasses.dataclass
class MapperConfig:
    max_mappings: int = 20000          # sampling budget for the mapspace
    orders: str = "representative"     # representative | exhaustive | random
    n_random_orders: int = 0
    enable_bypass: bool = True
    seed: int = 0
    # fraction of samples whose spatial factors are drawn greedily to fill
    # the fan-out (uniform divisor sampling almost never reaches high PE
    # counts on 7-dim bounds — this is how large mapspaces stay searchable)
    spatial_bias: float = 0.7
    # utilization-constraint pruner (paper §5.2)
    pe_utilization_min: float = 0.0
    innermem_utilization_min: float = 0.0
    # inter-layer activation words reserved at this level during validation
    act_reserve: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Mapspace:
    workload: Workload
    hardware: HardwareDesc
    mappings: List[Mapping]
    total_candidates: int              # before sampling/validation
    n_valid: int                       # after validation, before pruning


@dataclasses.dataclass
class MapspaceTables:
    """Shared candidate-index tables: one mapping candidate is a row of
    small indices (fi [7] into per-dim factor options, oi [L] into the
    order table or -1 for routing levels, bi [L] into per-level bypass
    choices).  Both the legacy object path (`build_mapspace`) and the
    array-native path (`core.mapspace_array.build_packed_mapspace`)
    generate candidates through these tables, so the two representations
    describe the *same* candidate set by construction."""
    per_dim: List[List[Tuple[int, ...]]]       # factor options per dim
    orders: List[Tuple[int, ...]]              # loop-order table
    canon_order: List[int]                     # value-dedup index per order
    bypass_choices: List[List[frozenset]]
    mem_idx: List[int]
    rout_idx: List[int]
    nl: int
    total: int                                 # full cartesian size
    first_rout: Optional[int]
    first_fanout: int                          # fanout at first_rout (or 1)
    by_spatial_idx: List[Dict[int, List[int]]]  # dim -> spatial -> opt idx


def _factor_options(workload: Workload, hw: HardwareDesc
                    ) -> List[List[Tuple[int, ...]]]:
    """Per-dim ordered factorizations, spatially over-subscribed options
    pruned early (exactly the seed constructor's candidate options)."""
    nl = len(hw.tiling_levels)
    rout_idx = hw.routing_level_indices()
    per_dim: List[List[Tuple[int, ...]]] = []
    for d in range(7):
        opts = ordered_factorizations(workload.dims[d], nl)
        keep = []
        for t in opts:
            ok = True
            for li in rout_idx:
                if t[li] > hw.tiling_levels[li].fanout:
                    ok = False
                    break
            if ok:
                keep.append(t)
        per_dim.append(keep)
    return per_dim


def mapspace_tables(workload: Workload, hw: HardwareDesc, cfg: MapperConfig,
                    rng: random.Random) -> MapspaceTables:
    """Build the candidate-index tables; consumes `rng` exactly like the
    seed constructor (random orders only)."""
    nl = len(hw.tiling_levels)
    mem_idx = hw.memory_level_indices()
    rout_idx = hw.routing_level_indices()
    per_dim = _factor_options(workload, hw)
    orders = _order_set(cfg, rng)
    bypass_choices = _bypass_choices(hw, cfg)
    total = math.prod(len(o) for o in per_dim) \
        * (len(orders) ** len(mem_idx)) \
        * math.prod(len(b) for b in bypass_choices)
    # canonical order index: random orders may collide with representative
    # ones; dedup must treat equal permutations as equal (value semantics)
    first_seen: Dict[Tuple[int, ...], int] = {}
    canon_order = []
    for i, o in enumerate(orders):
        canon_order.append(first_seen.setdefault(o, i))
    first_rout = min(rout_idx) if rout_idx else None
    first_fanout = hw.tiling_levels[first_rout].fanout \
        if first_rout is not None else 1
    by_spatial_idx: List[Dict[int, List[int]]] = []
    for d in range(7):
        idx: Dict[int, List[int]] = {}
        for i, t in enumerate(per_dim[d]):
            s = t[first_rout] if first_rout is not None else 1
            idx.setdefault(s, []).append(i)
        by_spatial_idx.append(idx)
    return MapspaceTables(per_dim=per_dim, orders=orders,
                          canon_order=canon_order,
                          bypass_choices=bypass_choices,
                          mem_idx=list(mem_idx), rout_idx=list(rout_idx),
                          nl=nl, total=total, first_rout=first_rout,
                          first_fanout=first_fanout,
                          by_spatial_idx=by_spatial_idx)


def enumerate_index_rows(tables: MapspaceTables):
    """Full cartesian enumeration as vectorized mixed-radix index arrays
    (fi [B, 7], oi [B, L], bi [B, L]); row order is exactly the seed's
    nested `itertools.product` order (factors outer, orders, bypass
    inner)."""
    import numpy as np
    T = tables
    mem = set(T.mem_idx)
    radices = [len(o) for o in T.per_dim] \
        + [len(T.orders) if li in mem else 1 for li in range(T.nl)] \
        + [len(b) for b in T.bypass_choices]
    k = np.arange(T.total, dtype=np.int64)
    digits = []
    for r in reversed(radices):
        digits.append((k % r).astype(np.int32))
        k //= r
    digits = digits[::-1]
    fi = np.stack(digits[:7], axis=1)
    oi = np.stack(digits[7:7 + T.nl], axis=1)
    for li in range(T.nl):
        if li not in mem:
            oi[:, li] = -1
    bi = np.stack(digits[7 + T.nl:], axis=1)
    return fi, oi, bi


def sample_index_rows(tables: MapspaceTables, cfg: MapperConfig,
                      seed: int):
    """Deduplicated candidate sampling as vectorized index arrays.

    Draws whole batches with a numpy PCG64 generator (deterministic given
    `seed`): the spatial-bias split, the greedy fan-out fill (random dim
    order per row, budget-constrained spatial divisor per dim, biased
    0.7 towards the largest usable one) and the uniform order/bypass
    picks are all batched array ops; only first-occurrence dedup walks
    rows.  Sampling semantics match the seed constructor's `sample_one`
    (same bias structure and distributions); the draw stream itself is
    the vectorized generator's.
    """
    import numpy as np
    T = tables
    rng = np.random.default_rng(seed)
    nd = np.asarray([len(o) for o in T.per_dim], np.int64)
    # spatial-option lookup per dim: sorted spatial keys, option indices
    # grouped by key (flat + offsets)
    sk, flat, off = [], [], []
    for d in range(7):
        keys = sorted(T.by_spatial_idx[d])
        sk.append(np.asarray(keys, np.int64))
        groups = [T.by_spatial_idx[d][s] for s in keys]
        flat.append(np.asarray(sum(groups, []), np.int64))
        off.append(np.concatenate(
            [[0], np.cumsum([len(g) for g in groups])]).astype(np.int64))
    mem = set(T.mem_idx)
    canon = np.asarray(T.canon_order, np.int64)

    def draw(M: int):
        # -- greedy spatial fill (vectorized over rows) -------------------
        if T.first_rout is not None:
            greedy = rng.random(M) < cfg.spatial_bias
        else:
            greedy = np.zeros((M,), bool)
        chosen = np.ones((M, 7), np.int64)
        if greedy.any():
            perm = np.argsort(rng.random((M, 7)), axis=1)      # dim order
            budget = np.full((M,), T.first_fanout, np.int64)
            for k in range(7):
                big = rng.random(M) < 0.7
                u = rng.random(M)
                for d in range(7):
                    rows = greedy & (perm[:, k] == d) & (budget > 1)
                    if not rows.any():
                        continue
                    cnt = np.searchsorted(sk[d], budget[rows], side="right")
                    pick_i = np.where(big[rows], cnt - 1,
                                      (u[rows] * cnt).astype(np.int64))
                    s = sk[d][pick_i]
                    chosen[rows, d] = s
                    budget[rows] //= s
        # -- factor-option index per dim ----------------------------------
        fi = np.empty((M, 7), np.int64)
        for d in range(7):
            uni = rng.integers(0, nd[d], M)
            j = np.searchsorted(sk[d], chosen[:, d])
            span = off[d][j + 1] - off[d][j]
            g = flat[d][off[d][j] + rng.integers(0, span)]
            fi[:, d] = np.where(greedy, g, uni)
        # -- order / bypass indices ---------------------------------------
        oi = np.full((M, T.nl), -1, np.int64)
        for li in range(T.nl):
            if li in mem:
                oi[:, li] = rng.integers(0, len(T.orders), M)
        bi = np.zeros((M, T.nl), np.int64)
        for li in range(T.nl):
            nb = len(T.bypass_choices[li])
            if nb > 1:
                bi[:, li] = rng.integers(0, nb, M)
        return fi, oi, bi

    seen = set()
    out_f, out_o, out_b = [], [], []
    n_out = 0
    drawn = 0
    max_draws = 20 * cfg.max_mappings
    while n_out < cfg.max_mappings and drawn < max_draws:
        M = min(max(2 * (cfg.max_mappings - n_out), 1024),
                max_draws - drawn)
        drawn += M
        fi, oi, bi = draw(M)
        key = np.ascontiguousarray(
            np.concatenate([fi, np.where(oi >= 0, canon[oi], -1), bi],
                           axis=1))
        kb = key.view(np.uint8).reshape(M, -1)
        take = []
        for r in range(M):
            k = kb[r].tobytes()
            if k not in seen:
                seen.add(k)
                take.append(r)
                n_out += 1
                if n_out >= cfg.max_mappings:
                    break
        take = np.asarray(take, np.int64)
        out_f.append(fi[take])
        out_o.append(oi[take])
        out_b.append(bi[take])
    fi = np.concatenate(out_f) if out_f else np.empty((0, 7), np.int64)
    oi = np.concatenate(out_o) if out_o else np.empty((0, T.nl), np.int64)
    bi = np.concatenate(out_b) if out_b else np.empty((0, T.nl), np.int64)
    return (fi.astype(np.int32), oi.astype(np.int32), bi.astype(np.int32))


def candidate_index_rows(workload: Workload, hw: HardwareDesc,
                         cfg: MapperConfig):
    """-> (tables, fi, oi, bi): the full candidate set when it fits the
    budget, the deduplicated vectorized sample otherwise."""
    rng = random.Random(cfg.seed)
    tables = mapspace_tables(workload, hw, cfg, rng)
    if tables.total <= cfg.max_mappings:
        fi, oi, bi = enumerate_index_rows(tables)
    else:
        fi, oi, bi = sample_index_rows(tables, cfg, cfg.seed)
    return tables, fi, oi, bi


def materialize_row(tables: MapspaceTables, workload: Workload,
                    hw: HardwareDesc, fi, oi, bi) -> Mapping:
    """One candidate index row -> a `Mapping` object."""
    T = tables
    factors = tuple(tuple(T.per_dim[d][fi[d]][li] for d in range(7))
                    for li in range(T.nl))
    ords = tuple(T.orders[oi[li]] if oi[li] >= 0 else None
                 for li in range(T.nl))
    byp = tuple(T.bypass_choices[li][bi[li]] for li in range(T.nl))
    return Mapping(workload, hw, factors, ords, byp)


def _order_set(cfg: MapperConfig, rng: random.Random):
    if cfg.orders == "exhaustive":
        return [tuple(p) for p in itertools.permutations(range(7))]
    orders = list(REPRESENTATIVE_ORDERS)
    for _ in range(cfg.n_random_orders):
        p = list(range(7))
        rng.shuffle(p)
        orders.append(tuple(p))
    return orders


def _bypass_choices(hw: HardwareDesc, cfg: MapperConfig):
    """Per memory level: frozensets of bypassed tensors.  DRAM (level 0)
    never bypasses; at most one intermediate level bypasses a given tensor
    combination (keeps the space sane)."""
    per_level = []
    for li in range(len(hw.tiling_levels)):
        lv = hw.tiling_levels[li]
        if lv.kind != "memory" or li == 0 or not cfg.enable_bypass:
            per_level.append([frozenset()])
        else:
            per_level.append([frozenset(), frozenset({"input"}),
                              frozenset({"weight"}), frozenset({"output"})])
    return per_level


def validate(mapping: Mapping, act_reserve: Optional[Dict[str, float]] = None
             ) -> bool:
    """Paper §5: hardware resource utilization needed <= provided."""
    hw = mapping.hardware
    # spatial fan-out
    for li, lv in enumerate(hw.tiling_levels):
        f = math.prod(mapping.factors[li])
        if lv.kind == "routing":
            if f > lv.fanout:
                return False
        elif lv.kind == "memory":
            pass
    # buffer capacities (+ reserved activation words, paper §5 validator)
    for li in hw.memory_level_indices():
        lv = hw.tiling_levels[li]
        if lv.size_words is None:
            continue
        reserve = (act_reserve or {}).get(lv.name, 0.0)
        if lv.usage == "split" and lv.split_sizes is not None:
            for ti, t in enumerate(TENSORS):
                if mapping.buffer_words(li, t) > lv.split_sizes[ti]:
                    return False
        else:
            used = sum(mapping.buffer_words(li, t) for t in TENSORS)
            if used + reserve > lv.size_words:
                return False
    # a tensor must be staged somewhere on chip if any loop splits it...
    # (DRAM always stages everything, so chains are always well-formed.)
    return True


def prune(mappings: Sequence[Mapping], cfg: MapperConfig) -> List[Mapping]:
    """Utilization-constraint pruner (paper §5.2)."""
    out = []
    for m in mappings:
        if cfg.pe_utilization_min > 0.0:
            if m.spatial_used() < cfg.pe_utilization_min * \
                    m.hardware.total_pes():
                continue
        if cfg.innermem_utilization_min > 0.0:
            li = m.hardware.memory_level_indices()[-1]
            lv = m.hardware.tiling_levels[li]
            if lv.size_words:
                used = sum(m.buffer_words(li, t) for t in TENSORS)
                if used < cfg.innermem_utilization_min * lv.size_words:
                    continue
        out.append(m)
    return out


def build_mapspace(workload: Workload, hw: HardwareDesc,
                   cfg: Optional[MapperConfig] = None) -> Mapspace:
    """Mapping constructor + validator + pruner (paper Fig. 5).

    This is the exact-parity legacy object path: candidates come from the
    same index-row generator as `core.mapspace_array.build_packed_mapspace`
    (the primary array-native representation) but are materialized into
    `Mapping` objects and validated/pruned with the scalar formulas.

    Emits the same `pack`/`validate` phase spans as the packed builder
    into the ambient `repro_torch.obs` tracer (no-op by default)."""
    from ..obs import current_tracer
    cfg = cfg or MapperConfig()
    tr = current_tracer()
    with tr.span("pack", phase=True, workload=workload.name,
                 arch=hw.name) as sp:
        tables, fi, oi, bi = candidate_index_rows(workload, hw, cfg)
        total = tables.total
        candidates: List[Mapping] = [
            materialize_row(tables, workload, hw, fi[b], oi[b], bi[b])
            for b in range(fi.shape[0])]
        sp.set(candidates=len(candidates), total=total)

    with tr.span("validate", phase=True, workload=workload.name) as sp:
        valid = [m for m in candidates if validate(m, cfg.act_reserve)]
        n_valid = len(valid)
        pruned = prune(valid, cfg)
        # If pruning removed everything (paper keeps constraints
        # optional), fall back to the valid space so the explorer still
        # finds a mapping.
        mappings = pruned if pruned else valid
        sp.set(n_valid=n_valid, survivors=len(mappings))
    return Mapspace(workload=workload, hardware=hw, mappings=mappings,
                    total_candidates=total, n_valid=n_valid)
