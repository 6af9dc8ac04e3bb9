"""TRIM mapping representation (paper §5.1).

A mapping projects a 7-dim workload onto the hardware's tiling levels
(outermost -> innermost).  Per tiling level it records:

  * factors  — 7 ints; the loop bounds of that level's sub-nest.  The product
    over levels of factors[d] equals the workload bound of dim d.
  * order    — permutation of the 7 dims, outermost-first (temporal/memory
    levels only; spatial order is irrelevant, paper §5.1).
  * bypass   — set of tensors not staged at this memory level (paper §5.2:
    "inputs, weights, or outputs may bypass some levels").

Tile semantics: the tile resident at tiling level l spans
    T(l)[d] = prod_{l' >= l} factors[l'][d]
(its own loops and everything inner; spatial fan-out inner to l is included
because a parent memory holds data for all parallel children).
"""
from __future__ import annotations

import dataclasses
import math
from typing import FrozenSet, Optional, Sequence, Tuple

from .designer import HardwareDesc
from .workload import DIMS, TENSORS, Workload

Perm = Tuple[int, ...]          # dim indices, outermost first


@dataclasses.dataclass(frozen=True)
class Mapping:
    workload: Workload
    hardware: HardwareDesc
    factors: Tuple[Tuple[int, ...], ...]      # [n_tiling_levels][7]
    orders: Tuple[Optional[Perm], ...]        # per level; None for routing
    bypass: Tuple[FrozenSet[str], ...]        # per level; empty for routing

    def __post_init__(self):
        nl = len(self.hardware.tiling_levels)
        assert len(self.factors) == nl and len(self.orders) == nl
        assert len(self.bypass) == nl
        for d in range(7):
            prod = math.prod(f[d] for f in self.factors)
            assert prod == self.workload.dims[d], (
                f"dim {DIMS[d]}: factors multiply to {prod}, "
                f"want {self.workload.dims[d]}")

    # ------------------------------------------------------------------
    def tile_dims(self, level: int) -> Tuple[int, ...]:
        """T(level): per-dim extent of the tile resident at `level`."""
        out = [1] * 7
        for f in self.factors[level:]:
            for d in range(7):
                out[d] *= f[d]
        return tuple(out)

    def child_tile_dims(self, level: int) -> Tuple[int, ...]:
        """Union tile delivered from `level` one step inward (includes any
        spatial fan-out below, i.e. T(level+1))."""
        return self.tile_dims(level + 1) if level + 1 < len(self.factors) \
            else (1,) * 7

    def tile_words(self, level: int, tensor: str) -> int:
        return self.workload.tile_words(tensor, self.tile_dims(level))

    def spatial_used(self) -> int:
        """Parallel PEs actually used = product of all spatial factors."""
        used = 1
        for i, lv in enumerate(self.hardware.tiling_levels):
            if lv.kind == "routing":
                used *= math.prod(self.factors[i])
        return used

    def stores(self, level: int, tensor: str) -> bool:
        lv = self.hardware.tiling_levels[level]
        if lv.kind != "memory":
            return False
        if tensor == "weight" and not self.workload.has_weight:
            return False
        return tensor not in self.bypass[level]

    def buffer_words(self, level: int, tensor: str) -> int:
        if not self.stores(level, tensor):
            return 0
        return self.tile_words(level, tensor)

    # -- pretty printing (paper Fig. 6 loop-nest format) ----------------
    def render(self) -> str:
        lines = []
        indent = 0
        for li, lv in enumerate(self.hardware.tiling_levels):
            tag = "parallel for" if lv.kind == "routing" else "for"
            lines.append(" " * indent + f"# level {lv.name}"
                         + (f" bypass={sorted(self.bypass[li])}"
                            if self.bypass[li] else ""))
            order = self.orders[li] or tuple(range(7))
            for d in order:
                b = self.factors[li][d]
                if b > 1:
                    lines.append(" " * indent
                                 + f"{tag} {DIMS[d].lower()}{li} in 0:{b}")
                    indent += 2
        lines.append(" " * indent + "MAC()")
        return "\n".join(lines)
