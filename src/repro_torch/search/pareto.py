"""Multi-objective support for the DSE search engine.

TRIM's explorer optimizes one scalar goal; real accelerator DSE asks
trade-off questions — how much energy does the next 2x of throughput cost,
which designs are worth fabricating at all.  `ParetoFront` maintains the
non-dominated set over a configurable tuple of minimized objectives
(default cycles/energy/area; EDP can be added) while strategies run, so a
single search pass answers the frontier question for free.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: objective name -> extractor over a NetworkEstimate-like object
OBJECTIVES = {
    "cycles": lambda n: n.cycles,
    "energy_pj": lambda n: n.energy_pj,
    "area_mm2": lambda n: n.area_mm2,
    "edp": lambda n: n.edp,
}

DEFAULT_OBJECTIVES: Tuple[str, ...] = ("cycles", "energy_pj", "area_mm2")


def objective_values(network, objectives: Sequence[str]) -> Tuple[float, ...]:
    """Extract the (minimized) objective tuple from a network estimate."""
    return tuple(float(OBJECTIVES[o](network)) for o in objectives)


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True iff `a` is no worse than `b` everywhere and better somewhere
    (all objectives minimized)."""
    no_worse = all(x <= y for x, y in zip(a, b))
    better = any(x < y for x, y in zip(a, b))
    return no_worse and better


def scalarize(values: Sequence[float],
              weights: Optional[Sequence[float]] = None,
              ref: Optional[Sequence[float]] = None) -> float:
    """Weighted-sum scalarization with optional per-objective normalization
    (`ref` = reference point, e.g. the current best per objective)."""
    w = weights or [1.0] * len(values)
    r = ref or [1.0] * len(values)
    return sum(wi * (v / max(ri, 1e-30)) for wi, v, ri in zip(w, values, r))


# ---------------------------------------------------------------------------
# hypervolume (all objectives minimized)
# ---------------------------------------------------------------------------
def ref_from_values(values: Sequence[Sequence[float]],
                    margin: float = 1.01) -> Tuple[float, ...]:
    """Reference point for hypervolume: the componentwise worst (max) over
    `values`, pushed out by `margin` so every point dominates it strictly.
    Fixing one ref across runs makes their hypervolumes comparable."""
    if not values:
        raise ValueError("need at least one value tuple for a ref point")
    ndim = len(values[0])
    return tuple(max(v[d] for v in values) * margin + 1e-30
                 for d in range(ndim))


def normalize_values(values: Sequence[Sequence[float]],
                     ref: Sequence[float]) -> List[Tuple[float, ...]]:
    """Divide each coordinate by the reference point's — the normalized
    ref is all-ones, so hypervolumes are scale-free and land in [0, 1]."""
    return [tuple(v / max(r, 1e-30) for v, r in zip(vals, ref))
            for vals in values]


def non_dominated(values: Sequence[Sequence[float]]) \
        -> List[Tuple[float, ...]]:
    """Non-dominated subset of `values` (duplicates kept once, first
    wins) — the pruning rule `ParetoFront.add` and `hypervolume` share."""
    front: List[Tuple[float, ...]] = []
    for v in values:
        v = tuple(v)
        if any(dominates(f, v) or f == v for f in front):
            continue
        front = [f for f in front if not dominates(v, f)]
        front.append(v)
    return front


def _hv(pts: List[Tuple[float, ...]], ref: Sequence[float]) -> float:
    """Exact hypervolume by recursive objective slicing (HSO).  `pts`
    must already be componentwise < ref.  Fronts here are small (tens of
    points), so the simple recursion is plenty."""
    if not pts:
        return 0.0
    if len(ref) == 1:
        return ref[0] - min(p[0] for p in pts)
    # slab the last objective: between consecutive z levels, the covered
    # (d-1)-volume is that of the points already "active" (last <= z)
    zs = sorted({p[-1] for p in pts})
    zs.append(ref[-1])
    vol = 0.0
    for lo, hi in zip(zs, zs[1:]):
        active = [p[:-1] for p in pts if p[-1] <= lo]
        if active:
            vol += (hi - lo) * _hv(active, ref[:-1])
    return vol


def hypervolume(values: Sequence[Sequence[float]],
                ref: Sequence[float],
                normalize: bool = True) -> float:
    """Dominated hypervolume of `values` w.r.t. reference point `ref`
    (all objectives minimized; bigger is better).  Points not strictly
    inside the ref box contribute nothing; dominated points are pruned
    first, so HV(raw set) == HV(its Pareto front) by construction.

    normalize=True computes in ref-normalized space (each coordinate
    divided by the ref's), making the result scale-invariant and <= 1.
    """
    vals = [tuple(float(x) for x in v) for v in values]
    if any(len(v) != len(ref) for v in vals):
        raise ValueError("objective/ref dimensionality mismatch")
    if normalize:
        vals = normalize_values(vals, ref)
        ref = (1.0,) * len(ref)
    inside = [v for v in vals
              if all(math.isfinite(x) and x < r for x, r in zip(v, ref))]
    return _hv(non_dominated(inside), tuple(ref))


@dataclasses.dataclass
class ParetoPoint:
    key: Any                       # caller identity (arch name / coords)
    values: Tuple[float, ...]      # objective tuple, minimized
    payload: Any = None            # e.g. the ArchResult


class ParetoFront:
    """Incrementally maintained non-dominated set (all objectives minimized).

    `add` returns True iff the point joins the frontier; dominated incumbents
    are evicted.  Equal-valued points are kept once (first wins).
    """

    def __init__(self, objectives: Sequence[str] = DEFAULT_OBJECTIVES):
        for o in objectives:
            if o not in OBJECTIVES:
                raise KeyError(f"unknown objective {o!r}; "
                               f"have {sorted(OBJECTIVES)}")
        self.objectives: Tuple[str, ...] = tuple(objectives)
        self._points: List[ParetoPoint] = []
        self.n_offered = 0
        self.n_evicted = 0
        #: componentwise worst value ever *offered* (accepted or not) —
        #: a stable default hypervolume reference for this front's run
        self.nadir: Optional[Tuple[float, ...]] = None

    def __len__(self) -> int:
        return len(self._points)

    def points(self) -> List[ParetoPoint]:
        return list(self._points)

    def values(self) -> List[Tuple[float, ...]]:
        return [p.values for p in self._points]

    def add(self, key: Any, values: Sequence[float],
            payload: Any = None) -> bool:
        vals = tuple(float(v) for v in values)
        if len(vals) != len(self.objectives):
            raise ValueError(f"expected {len(self.objectives)} objectives, "
                             f"got {len(vals)}")
        if any(math.isnan(v) for v in vals):
            return False
        self.n_offered += 1
        if all(math.isfinite(v) for v in vals):
            self.nadir = vals if self.nadir is None else tuple(
                max(a, b) for a, b in zip(self.nadir, vals))
        for p in self._points:
            if dominates(p.values, vals) or p.values == vals:
                return False
        keep = [p for p in self._points if not dominates(vals, p.values)]
        self.n_evicted += len(self._points) - len(keep)
        keep.append(ParetoPoint(key=key, values=vals, payload=payload))
        self._points = keep
        return True

    def add_network(self, key: Any, network, payload: Any = None) -> bool:
        return self.add(key, objective_values(network, self.objectives),
                        payload)

    def dominated(self, values: Sequence[float]) -> bool:
        vals = tuple(float(v) for v in values)
        return any(dominates(p.values, vals) for p in self._points)

    def best(self, objective: str) -> Optional[ParetoPoint]:
        """Frontier point minimizing one objective."""
        if not self._points:
            return None
        i = self.objectives.index(objective)
        return min(self._points, key=lambda p: p.values[i])

    def ref_point(self, margin: float = 1.01) -> Tuple[float, ...]:
        """Default hypervolume reference: the worst value ever offered,
        pushed out by `margin`.  For cross-run comparisons pass one
        explicit ref to both computations instead."""
        if self.nadir is None:
            raise ValueError("empty front: no finite points offered yet")
        return ref_from_values([self.nadir], margin)

    def hypervolume(self, ref: Optional[Sequence[float]] = None,
                    normalize: bool = True) -> float:
        """Dominated hypervolume of the frontier (bigger is better)."""
        if not self._points:
            return 0.0
        return hypervolume(self.values(), ref or self.ref_point(),
                           normalize=normalize)

    def summary(self) -> List[Dict[str, Any]]:
        """JSON-friendly view (for SearchReport / benchmark emission)."""
        return [{"key": str(p.key),
                 **{o: v for o, v in zip(self.objectives, p.values)}}
                for p in sorted(self._points, key=lambda p: p.values)]
