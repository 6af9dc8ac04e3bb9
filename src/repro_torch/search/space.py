"""Architecture search space: a discrete lattice of design parameters.

The TRIM Designer enumerates a cartesian product of architecture parameters
(paper Table 1, Algorithm 1 line 4).  Smarter-than-exhaustive strategies
need *structure* on that product — neighborhoods for annealing moves,
per-axis genes for evolutionary crossover — so the space is modeled as a
lattice: named axes of ordered values plus a build function mapping one
coordinate tuple to a `HardwareDesc`.  A plain iterable of descriptions
(the seed explorer's API) wraps as a 1-D lattice, keeping every existing
caller working.
"""
from __future__ import annotations

import itertools
import random
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from ..core.designer import HardwareDesc, make_spatial_arch

Coords = Tuple[int, ...]


class ArchSpace:
    """Discrete lattice over architecture parameters.

    axes   : ordered mapping axis name -> tuple of values (ordered so that
             +-1 coordinate steps are meaningful "nudges")
    build  : kwargs (one per axis) -> HardwareDesc; memoized per coordinate
    """

    def __init__(self, axes: Dict[str, Sequence],
                 build: Callable[..., HardwareDesc]):
        if not axes:
            raise ValueError("ArchSpace needs at least one axis")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.axis_values: Tuple[Tuple, ...] = tuple(
            tuple(axes[n]) for n in self.axis_names)
        if any(len(v) == 0 for v in self.axis_values):
            raise ValueError("empty axis in ArchSpace")
        self.build = build
        self._cache: Dict[Coords, HardwareDesc] = {}

    # -- construction ----------------------------------------------------
    @classmethod
    def from_archs(cls, archs: Iterable[HardwareDesc]) -> "ArchSpace":
        """Wrap an explicit architecture list as a 1-D lattice (preserves
        iteration order, so exhaustive search matches the seed explorer)."""
        lst = list(archs)
        if not lst:
            raise ValueError("empty architecture space")
        return cls({"arch": tuple(range(len(lst)))},
                   lambda arch: lst[arch])

    @classmethod
    def spatial(cls, *, num_pes: Sequence[int], rf_words: Sequence[int],
                gbuf_words: Sequence[int], bits: int = 32,
                zero_skip: bool = True, **kw) -> "ArchSpace":
        """The paper's PEs x RF x Gbuf lattice (Designer template), with
        names matching `generate_arch_space`."""
        def build(num_pes, rf_words, gbuf_words):
            return make_spatial_arch(
                name=f"pe{num_pes}_rf{rf_words}_gb{gbuf_words}",
                num_pes=num_pes, rf_words=rf_words, gbuf_words=gbuf_words,
                bits=bits, zero_skip=zero_skip, **kw)
        return cls({"num_pes": tuple(num_pes), "rf_words": tuple(rf_words),
                    "gbuf_words": tuple(gbuf_words)}, build)

    # -- lattice geometry ------------------------------------------------
    @property
    def size(self) -> int:
        n = 1
        for v in self.axis_values:
            n *= len(v)
        return n

    @property
    def ndim(self) -> int:
        return len(self.axis_names)

    def values_at(self, coords: Coords) -> Dict[str, object]:
        return {n: self.axis_values[i][c]
                for i, (n, c) in enumerate(zip(self.axis_names, coords))}

    def at(self, coords: Coords) -> HardwareDesc:
        coords = tuple(coords)
        hw = self._cache.get(coords)
        if hw is None:
            hw = self.build(**self.values_at(coords))
            self._cache[coords] = hw
        return hw

    def all_coords(self) -> Iterable[Coords]:
        """Row-major enumeration (first axis outermost) — the seed
        Designer's `itertools.product` order."""
        return itertools.product(*(range(len(v)) for v in self.axis_values))

    def random_coords(self, rng: random.Random) -> Coords:
        return tuple(rng.randrange(len(v)) for v in self.axis_values)

    def neighbors(self, coords: Coords) -> List[Coords]:
        """+-1 step along one axis (the anneal move set)."""
        out: List[Coords] = []
        for i, v in enumerate(self.axis_values):
            for step in (-1, 1):
                c = coords[i] + step
                if 0 <= c < len(v):
                    out.append(coords[:i] + (c,) + coords[i + 1:])
        return out

    def mutate(self, coords: Coords, rng: random.Random,
               p: float = 0.35) -> Coords:
        """Per-axis +-1 nudge with probability p (evolutionary mutation)."""
        out = list(coords)
        for i, v in enumerate(self.axis_values):
            if len(v) > 1 and rng.random() < p:
                step = rng.choice((-1, 1))
                out[i] = min(len(v) - 1, max(0, out[i] + step))
        return tuple(out)

    def crossover(self, a: Coords, b: Coords, rng: random.Random) -> Coords:
        """Uniform per-axis gene mix."""
        return tuple(ai if rng.random() < 0.5 else bi
                     for ai, bi in zip(a, b))


def as_space(arch_space) -> ArchSpace:
    """Accept an ArchSpace or any iterable of HardwareDesc."""
    if isinstance(arch_space, ArchSpace):
        return arch_space
    return ArchSpace.from_archs(arch_space)
