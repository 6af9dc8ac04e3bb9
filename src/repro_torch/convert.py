"""The JAX package's inputs, as plain numpy and dicts, -> the port's objects.

Both packages describe hardware, workloads and packed mapspaces with
dataclasses of the same fields.  `dataclasses.asdict` of the JAX side's
object is the exchange format: these functions rebuild the port's
counterpart from it, so the same packed arrays can be scored by both
packages and compared, independent of either mapper.  Model parameters
travel as the reference's `init_model` tree of numpy arrays
(`load_model_params`).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

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


STACKED = ("layers", "dense_layers", "enc_layers", "dec_layers")


def model_state_from_tree(tree: dict) -> Dict[str, np.ndarray]:
    """The reference's `init_model` params tree (nested dicts of arrays,
    the blocks of each `STACKED` key stacked on axis 0) -> the port
    `Model`'s `state_dict` keys (`layers.<i>.attn.wq`, ...) and arrays."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key, val in node.items():
            name = prefix + key
            if key in STACKED:
                n = len(next(iter(_leaves(val))))
                for i in range(n):
                    walk(_index(val, i), f"{name}.{i}.")
            elif isinstance(val, dict):
                walk(val, name + ".")
            else:
                out[name] = np.asarray(val)

    walk(tree, "")
    return out


def _leaves(node):
    for val in node.values():
        if isinstance(val, dict):
            yield from _leaves(val)
        else:
            yield val


def _index(node, i: int):
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in node.items()}


def load_model_params(model: torch.nn.Module, tree: dict):
    """Copy the reference's params tree into `model` (a port `Model` of
    the same config) in place, cast to each parameter's type; -> model.
    Raises when a key is missing on either side or a shape differs."""
    state = model_state_from_tree(tree)
    params = dict(model.named_parameters())
    if set(state) != set(params):
        raise KeyError(f"params differ: only in the tree "
                       f"{sorted(set(state) - set(params))}, only in the "
                       f"model {sorted(set(params) - set(state))}")
    with torch.no_grad():
        for name, p in params.items():
            a = np.array(state[name], dtype=np.float32)
            if a.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {a.shape}, model has "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(a).to(p.device, p.dtype))
    return model
