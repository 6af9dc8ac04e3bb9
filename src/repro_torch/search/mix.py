"""Heterogeneous accelerator mixes as first-class `ArchSpace` points.

`MixSpace` composes an existing base `ArchSpace` into a lattice whose
points are `MixDesc` tuples: `slots` independent copies of the base
axes (one sub-lattice per mix slot) plus an optional member-count axis
replicating each slot's design.  Because `MixSpace` *is* an
`ArchSpace`, every registered strategy, the constraint short-circuit,
`run_search`, and the DSE service consume it unchanged — the driver
only specializes once it sees a `MixDesc` point (per-member sub-jobs +
the `core.scheduler` assignment).

Axis layout (this is a parity-critical contract, pinned by
tests/test_mix_parity.py):

  * ``slots == 1`` with a single count choice exposes **exactly the
    base space's axes** — same names, same values, no extra axis.
    Strategies draw RNG per axis (`random_coords` calls
    ``rng.randrange`` once per axis), so any extra length-1 axis would
    desynchronize anneal/evolve/bandit proposal streams and break the
    bit-identical 1-member-mix parity guarantee.
  * otherwise: an optional leading ``counts`` axis (one value per
    replication tuple) followed by each slot's base axes renamed
    ``m{slot}__{axis}``.

`shared_bw_level` splits that memory level's bandwidth evenly across
members (`core.scheduler.make_mix`), modeling a shared DRAM/HBM
interface through the existing `Level` bandwidth model.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from ..core.scheduler import MixDesc, make_mix
from .space import ArchSpace, as_space


class MixSpace(ArchSpace):
    """Lattice of heterogeneous mixes over a base architecture space.

    base            : ArchSpace (or iterable of HardwareDesc) giving the
                      per-slot design axes
    slots           : number of independent member designs in each mix
    counts          : replication choices — each entry is a tuple of
                      per-slot member counts (e.g. ``((1, 1), (1, 2))``
                      offers "one of each" and "one big + two small");
                      default one-of-each
    shared_bw_level : memory level whose bandwidth is split evenly
                      across all members (e.g. ``"DRAM"``), or None
    """

    def __init__(self, base, slots: int = 1,
                 counts: Optional[Sequence[Sequence[int]]] = None,
                 shared_bw_level: Optional[str] = None):
        base = as_space(base)
        slots = int(slots)
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if counts is None:
            counts = ((1,) * slots,)
        counts = tuple(tuple(int(x) for x in c) for c in counts)
        if not counts:
            raise ValueError("counts must offer at least one choice")
        for c in counts:
            if len(c) != slots:
                raise ValueError(f"count tuple {c} has {len(c)} entries "
                                 f"for {slots} slots")
            if any(x < 1 for x in c):
                raise ValueError(f"member counts must be >= 1, got {c}")
        if len(set(counts)) != len(counts):
            raise ValueError(f"duplicate count tuples in {counts}")
        self.base = base
        self.slots = slots
        self.counts = counts
        self.shared_bw_level = shared_bw_level
        self._has_counts_axis = len(counts) > 1
        axes: Dict[str, Sequence] = {}
        if self._has_counts_axis:
            if slots == 1 and "counts" in base.axis_names:
                raise ValueError(
                    "base space already has a 'counts' axis — it would "
                    "collide with the mix replication axis")
            axes["counts"] = counts
        if slots == 1:
            # parity layout: identical axes to the base space (see
            # module docstring) — coordinates round-trip unchanged
            for n, vals in zip(base.axis_names, base.axis_values):
                axes[n] = vals
        else:
            for s in range(slots):
                for n, vals in zip(base.axis_names, base.axis_values):
                    axes[f"m{s}__{n}"] = vals
        super().__init__(axes, self._build_from_values)
        # value -> index maps let _build_from_values reuse the base
        # space's memoized `at()` (falls back to base.build for
        # unhashable axis values)
        try:
            self._vindex: Optional[Tuple[Dict, ...]] = tuple(
                {v: i for i, v in enumerate(vals)}
                for vals in base.axis_values)
        except TypeError:
            self._vindex = None

    def _base_design(self, values: Dict[str, object]):
        if self._vindex is not None:
            coords = tuple(self._vindex[i][values[n]]
                           for i, n in enumerate(self.base.axis_names))
            return self.base.at(coords)
        return self.base.build(**values)

    def _build_from_values(self, **kw) -> MixDesc:
        counts = (kw.pop("counts") if self._has_counts_axis
                  else self.counts[0])
        members = []
        for s in range(self.slots):
            if self.slots == 1:
                values = kw
            else:
                values = {n: kw[f"m{s}__{n}"]
                          for n in self.base.axis_names}
            hw = self._base_design(values)
            members.extend([hw] * counts[s])
        return make_mix(members, shared_bw_level=self.shared_bw_level)
