"""Declarative hardware-budget constraints for the DSE search engine.

TRIM's headline workflow (paper §6 case studies) is *budget-constrained*
design selection: pick the goal-best accelerator that also fits an area
envelope, a power cap, or a latency deadline.  `Constraint` states one
such budget over an evaluated design's metrics (area_mm2 / power_w /
energy_pj / cycles / edp / seconds); `ConstraintSet` bundles several with
an infeasibility policy and is what `run_search(constraints=…)` consumes:

  * feasibility — only feasible designs join the Pareto frontier and the
    best-architecture ranking;
  * penalty / death policy — strategies still receive feedback for
    infeasible designs ("penalty": goal inflated proportionally to the
    relative violation, preserving gradient toward the feasible region;
    "death": +inf, hard rejection);
  * static short-circuit — constraints decidable from the hardware
    description alone (area: `hw.total_area()` needs no mapping search)
    reject an architecture *before* any mapspace is built or scored;
  * digest — a sha256 over the canonical constraint encoding joins the
    result-cache key, so constrained and unconstrained entries (or runs
    under different budgets) can never alias.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import (Any, Dict, Iterable, List, Optional, Sequence, Tuple,
                    Union)

#: metric name -> extractor over (NetworkEstimate-like, HardwareDesc)
METRICS = {
    "cycles": lambda n, hw: n.cycles,
    "energy_pj": lambda n, hw: n.energy_pj,
    "area_mm2": lambda n, hw: n.area_mm2,
    "edp": lambda n, hw: n.edp,
    "seconds": lambda n, hw: n.cycles / hw.frequency_hz,
    "power_w": lambda n, hw: (n.energy_pj * 1e-12)
    / max(n.cycles / hw.frequency_hz, 1e-30),
}

#: metrics decidable from the HardwareDesc alone (no mapping search) —
#: these short-circuit evaluation of statically infeasible designs
STATIC_METRICS = {
    "area_mm2": lambda hw: hw.total_area(),
}

SENSES = ("<=", ">=")


@dataclasses.dataclass(frozen=True)
class Constraint:
    """One budget: `metric sense bound`, e.g. area_mm2 <= 12.5."""
    metric: str
    bound: float
    sense: str = "<="

    def __post_init__(self):
        if self.metric not in METRICS:
            raise KeyError(f"unknown constraint metric {self.metric!r}; "
                           f"have {sorted(METRICS)}")
        if self.sense not in SENSES:
            raise ValueError(f"sense must be one of {SENSES}, "
                             f"got {self.sense!r}")
        if not math.isfinite(self.bound) or self.bound <= 0:
            raise ValueError(f"bound must be a positive finite number, "
                             f"got {self.bound!r}")

    # -- constructors ----------------------------------------------------
    @classmethod
    def le(cls, metric: str, bound: float) -> "Constraint":
        return cls(metric, float(bound), "<=")

    @classmethod
    def ge(cls, metric: str, bound: float) -> "Constraint":
        return cls(metric, float(bound), ">=")

    @classmethod
    def parse(cls, text: str) -> "Constraint":
        """"area_mm2<=12.5" / "cycles >= 1e6" -> Constraint."""
        for sense in SENSES:
            if sense in text:
                metric, bound = text.split(sense, 1)
                return cls(metric.strip(), float(bound), sense)
        raise ValueError(f"cannot parse constraint {text!r}; "
                         f"expected '<metric><=|>=<bound>'")

    # -- evaluation ------------------------------------------------------
    def value(self, network, hw) -> float:
        return float(METRICS[self.metric](network, hw))

    def static_value(self, hw) -> Optional[float]:
        """Metric value decidable from the hardware alone, else None."""
        fn = STATIC_METRICS.get(self.metric)
        return None if fn is None else float(fn(hw))

    def satisfied(self, value: float) -> bool:
        return value <= self.bound if self.sense == "<=" \
            else value >= self.bound

    def violation(self, value: float) -> float:
        """Relative violation magnitude: 0 when satisfied, else the
        fractional distance past the bound (scale-free, so violations of
        differently-scaled metrics sum meaningfully)."""
        if not math.isfinite(value):
            return math.inf
        if self.sense == "<=":
            return max(0.0, (value - self.bound) / self.bound)
        return max(0.0, (self.bound - value) / self.bound)

    def signature(self) -> Dict[str, Any]:
        return {"metric": self.metric, "sense": self.sense,
                "bound": self.bound}

    def __str__(self) -> str:
        return f"{self.metric}{self.sense}{self.bound:g}"


ConstraintLike = Union[Constraint, str]


class ConstraintSet:
    """An AND-conjunction of constraints plus the infeasibility policy.

    policy="penalty" (default): infeasible designs feed the strategy
    `goal * (1 + penalty_weight * total_relative_violation)` — finite,
    ordered by violation, so search is repelled from (but can traverse)
    the infeasible region.  policy="death": infeasible designs feed +inf.
    """

    #: pseudo-goal base for designs rejected before evaluation (static
    #: short-circuit) — far above any real goal value, still ordered by
    #: violation so strategies sense the feasibility boundary
    SKIP_BASE = 1e30

    def __init__(self, constraints: Iterable[ConstraintLike],
                 policy: str = "penalty", penalty_weight: float = 10.0):
        if policy not in ("penalty", "death"):
            raise ValueError(f"policy must be 'penalty' or 'death', "
                             f"got {policy!r}")
        self.constraints: Tuple[Constraint, ...] = tuple(
            c if isinstance(c, Constraint) else Constraint.parse(c)
            for c in constraints)
        if not self.constraints:
            raise ValueError("empty ConstraintSet; pass constraints=None "
                             "for an unconstrained search")
        self.policy = policy
        self.penalty_weight = float(penalty_weight)

    @classmethod
    def from_any(cls, spec) -> Optional["ConstraintSet"]:
        """None | ConstraintSet | Constraint | str | iterable thereof."""
        if spec is None:
            return None
        if isinstance(spec, ConstraintSet):
            return spec
        if isinstance(spec, (Constraint, str)):
            spec = [spec]
        return cls(spec)

    def __len__(self) -> int:
        return len(self.constraints)

    def __iter__(self):
        return iter(self.constraints)

    def __str__(self) -> str:
        return " & ".join(str(c) for c in self.constraints)

    # -- feasibility -----------------------------------------------------
    def violation(self, network, hw) -> float:
        return sum(c.violation(c.value(network, hw))
                   for c in self.constraints)

    def is_feasible(self, network, hw) -> bool:
        return all(c.satisfied(c.value(network, hw))
                   for c in self.constraints)

    def static_violation(self, hw) -> float:
        """Total violation over statically-decidable constraints only."""
        total = 0.0
        for c in self.constraints:
            v = c.static_value(hw)
            if v is not None:
                total += c.violation(v)
        return total

    def statically_infeasible(self, hw) -> bool:
        """True iff the hardware description alone already violates a
        constraint — evaluation (mapspace build + scoring) is pointless."""
        return self.static_violation(hw) > 0.0

    # -- strategy feedback -----------------------------------------------
    def penalized(self, goal_value: float, violation: float) -> float:
        """Scalar feedback for an evaluated-but-infeasible design."""
        if violation <= 0.0:
            return goal_value
        if self.policy == "death" or not math.isfinite(violation):
            return math.inf
        return goal_value * (1.0 + self.penalty_weight * violation)

    def skip_value(self, static_violation: float) -> float:
        """Scalar feedback for a statically-rejected (never evaluated)
        design: worse than any evaluated design, ordered by violation."""
        if self.policy == "death" or not math.isfinite(static_violation):
            return math.inf
        return self.SKIP_BASE * (1.0 + self.penalty_weight
                                 * static_violation)

    # -- objective-space masking (Pareto filter equivalence) -------------
    def objective_mask(self, objectives: Sequence[str],
                       values: Sequence[Sequence[float]]) -> List[bool]:
        """Feasibility mask over objective tuples, for the constraints
        expressible in that objective space (metric ∈ objectives);
        constraints over other metrics are ignored here.  Used by the
        filter-then-front == front-then-filter property tests."""
        idx = {o: i for i, o in enumerate(objectives)}
        active = [(c, idx[c.metric]) for c in self.constraints
                  if c.metric in idx]
        return [all(c.satisfied(v[i]) for c, i in active) for v in values]

    # -- cache identity --------------------------------------------------
    def signature(self) -> Dict[str, Any]:
        return {"constraints": [c.signature() for c in self.constraints],
                "policy": self.policy,
                "penalty_weight": self.penalty_weight}

    def digest(self) -> str:
        blob = json.dumps(self.signature(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()
