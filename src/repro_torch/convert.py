"""The JAX package's inputs, as plain numpy and dicts, -> the port's objects.

Both packages describe hardware, workloads and packed mapspaces with
dataclasses of the same fields.  `dataclasses.asdict` of the JAX side's
object is the exchange format: these functions rebuild the port's
counterpart from it, so the same packed arrays can be scored by both
packages and compared, independent of either mapper.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .core.batch_eval import HwStatic
from .core.designer import HardwareDesc, Level
from .core.mapspace_array import PackedMapspace
from .core.workload import Workload


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def static_from_dict(d: dict) -> HwStatic:
    """`dataclasses.asdict` of an `HwStatic` -> the port's `HwStatic`."""
    return HwStatic(**_tuples(d))


def workload_from_dict(d: dict) -> Workload:
    """`dataclasses.asdict` of a `Workload` -> the port's `Workload`."""
    return Workload(**_tuples(d))


def hardware_from_dict(d: dict) -> HardwareDesc:
    """`dataclasses.asdict` of a `HardwareDesc` -> the port's."""
    levels = tuple(Level(**_tuples(lv)) for lv in d["levels"])
    return HardwareDesc(**{**d, "levels": levels})


def packed_from_arrays(static: HwStatic, factors, rank, store, eligible, *,
                       workload: Optional[Workload] = None,
                       hardware: Optional[HardwareDesc] = None,
                       total_candidates: Optional[int] = None,
                       n_valid: Optional[int] = None) -> PackedMapspace:
    """Packed host arrays -> a `PackedMapspace` that scores (backend,
    fused search) but has no index rows to materialize mappings from."""
    factors = np.asarray(factors, np.int32)
    n = factors.shape[0]
    return PackedMapspace(
        workload=workload, hardware=hardware, static=static,
        factors=factors, rank=np.asarray(rank, np.int32),
        store=np.asarray(store, bool), eligible=np.asarray(eligible, bool),
        fi=None, oi=None, bi=None, tables=None,
        total_candidates=n if total_candidates is None else total_candidates,
        n_valid=n if n_valid is None else n_valid)
