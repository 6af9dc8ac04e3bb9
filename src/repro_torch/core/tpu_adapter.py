"""TRIM as a sharding planner for the TPU pod (DESIGN.md §3.2).

The pod is described in TRIM's own hardware template:

  level 0  memory   "HBM"   — aggregate pod HBM (bw = chips x 819 GB/s)
  level 1  routing  "ICI"   — fan-out = n_chips; spatial loop dims ARE the
                              sharding decision
  level 2  memory   "VMEM"  — 128 MB/chip on-chip vector memory
  level 3  compute  "MXU"   — 197 TFLOP/s bf16 per chip

and the paper's spatial-dim classification (§6.1) is exactly SPMD
partitioning:

  N spatial (tokens)   -> data parallel, weights multicast  = weight
                          all-gather (FSDP)
  M spatial (features) -> tensor parallel over output dim, inputs multicast
                          = activation all-gather
  C spatial (reduction)-> partial sums accumulated = all-reduce

For each dominant workload of an (arch x shape) cell the planner evaluates
all (N, M, C) x (data, model) spatial factorizations with the *TRIM
evaluator* and returns the best assignment, exported as logical-rule
overrides for the launcher (`--sharding trim`).

A framework-free copy of the JAX package's `core/tpu_adapter.py` over the
port's own `configs`, `designer`, `evaluator`, `lower_lm`, `mapping` and
`workload`: the same names, constants and plans.  It runs on the host
only (no device, no kernel).  `trim_sharding_overrides` takes the mesh's
axis sizes as a mapping from axis name to size (the reference reads
`mesh.axis_names` and `mesh.devices.shape`, nothing else); a torch
`DeviceMesh` gives it as `dict(zip(mesh.mesh_dim_names, mesh.shape))`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec
from .designer import HardwareDesc, Level
from .evaluator import evaluate_mapping
from .lower_lm import lower_block
from .mapping import Mapping
from .workload import Workload, N_, M_, C_

# v5e-class constants (bytes are modeled in 2-byte words: bf16)
PEAK_MACS_PER_CHIP_PER_CYCLE = 98_500     # 197 TFLOP/s bf16 @ 1 GHz
HBM_WORDS_PER_CHIP_PER_CYCLE = 410        # 819 GB/s / 2B @ 1 GHz
ICI_WORDS_PER_CHIP_PER_CYCLE = 25         # 50 GB/s/link / 2B @ 1 GHz
VMEM_WORDS = 64 * 1024 * 1024             # 128 MB / 2B


def make_tpu_pod_desc(n_chips: int) -> HardwareDesc:
    levels = (
        Level(kind="memory", name="HBM", size_words=None,
              bandwidth=float(HBM_WORDS_PER_CHIP_PER_CYCLE),
              read_energy=1.0, write_energy=1.0),
        Level(kind="routing", name="ICI", fanout=n_chips,
              bandwidth=float(ICI_WORDS_PER_CHIP_PER_CYCLE * n_chips),
              unicast_energy=2.0, multicast_energy=1.0, accum_energy=2.5),
        Level(kind="memory", name="VMEM", size_words=VMEM_WORDS,
              bandwidth=float(8 * HBM_WORDS_PER_CHIP_PER_CYCLE),
              read_energy=0.05, write_energy=0.05),
        Level(kind="compute", name="MXU", num_pes=n_chips,
              macs_per_pe=PEAK_MACS_PER_CHIP_PER_CYCLE, pipeline=1,
              mac_energy=0.0002),
    )
    return HardwareDesc(name=f"tpu-pod-{n_chips}", levels=levels,
                        precision_bits=16, frequency_hz=1e9)


@dataclasses.dataclass
class PlanChoice:
    workload: str
    data_dim: str          # N | M | C   (dim sharded over the data axis)
    model_dim: str         # N | M | C   (dim sharded over the model axis)
    cycles: float
    macs: float


def _factor_clip(bound: int, want: int) -> int:
    """Largest divisor of `bound` that is <= want (spatial factor must
    divide the loop bound)."""
    for f in range(min(want, bound), 0, -1):
        if bound % f == 0:
            return f
    return 1


def plan_workload(wl: Workload, *, data_par: int, model_par: int,
                  hw: Optional[HardwareDesc] = None) -> List[PlanChoice]:
    """Evaluate all (data_dim, model_dim) spatial assignments with the TRIM
    evaluator; return choices sorted best-first."""
    n_chips = data_par * model_par
    hw = hw or make_tpu_pod_desc(n_chips)
    dims = {"N": N_, "M": M_, "C": C_}
    choices = []
    for dname, dd in dims.items():
        for mname, md in dims.items():
            spatial = [1] * 7
            fd = _factor_clip(wl.dims[dd], data_par)
            if dname == mname:
                fm = _factor_clip(wl.dims[dd] // fd, model_par)
                spatial[dd] = fd * fm
            else:
                fm = _factor_clip(wl.dims[md], model_par)
                spatial[dd] = fd
                spatial[md] = fm
            # temporal loops: everything else at HBM level; VMEM gets a
            # modest tile (the evaluator only needs relative ranking).
            hbm = [wl.dims[i] // spatial[i] if i in (dd, md)
                   else wl.dims[i] for i in range(7)]
            vmem = [1] * 7
            factors = (tuple(hbm), tuple(spatial), tuple(vmem))
            orders = (tuple(range(7)), None, tuple(range(7)))
            bypass = (frozenset(), frozenset(), frozenset())
            m = Mapping(wl, hw, factors, orders, bypass)
            est = evaluate_mapping(m)
            choices.append(PlanChoice(workload=wl.name, data_dim=dname,
                                      model_dim=mname, cycles=est.cycles,
                                      macs=wl.macs))
    choices.sort(key=lambda c: c.cycles)
    return choices


def plan_cell(cfg: ModelConfig, spec: ShapeSpec, *, data_par: int,
              model_par: int, top_workloads: int = 4
              ) -> Dict[str, PlanChoice]:
    """Plan the dominant workloads of one (arch x shape) cell."""
    lowered = lower_block(cfg, spec)
    wls = sorted(lowered.workloads, key=lambda w: -w.macs)[:top_workloads]
    hw = make_tpu_pod_desc(data_par * model_par)
    return {w.name: plan_workload(w, data_par=data_par,
                                  model_par=model_par, hw=hw)[0]
            for w in wls}


def trim_sharding_overrides(cfg: ModelConfig, spec: ShapeSpec,
                            axes: Dict[str, int]) -> Dict[str, object]:
    """Map the planner's winning choice for the *dominant* workload onto
    logical-rule overrides (`parallel.sharding.make_rules(mesh,
    overrides=...)`, the vocabulary of the JAX package's rules).  `axes`
    maps each mesh axis name to its size."""
    data = axes.get("data", 1) * axes.get("pod", 1)
    model = axes.get("model", 1)
    plans = plan_cell(cfg, spec, data_par=data, model_par=model)
    # dominant = most MACs
    dom = max(plans.values(), key=lambda c: c.macs)
    overrides: Dict[str, object] = {}
    if dom.model_dim == "N":
        # pure data parallel: fold the model axis into batch sharding
        overrides["batch"] = tuple(a for a in ("pod", "data", "model")
                                   if a in axes)
        for ax in ("ff", "heads", "vocab", "experts", "ssm_inner"):
            overrides[ax] = None
    elif dom.model_dim == "C":
        # reduction sharding: shard d_model (contracting dim) over model
        overrides["embed"] = "model"
        overrides["ff"] = None
        overrides["heads"] = None
    # dom.model_dim == "M": baseline TP — no overrides
    return overrides
