"""Roofline terms of one step, from a traced run on DTensor (the port of
the JAX package's `launch/roofline.py`).

Three terms per (arch x shape x mesh), in seconds:

  compute    = FLOPs_per_device / peak_FLOPs
  memory     = bytes_per_device / HBM_bw
  collective = ring-transfer bytes per device / link_bw

The defaults are the card's: NVIDIA H100 80GB HBM3 (SXM, 700 W): 989
TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s of NVLink a direction.  Pass
other constants as keyword arguments (`make_roofline(..., peak_flops=)`).

The reference reads XLA's compiled HLO (`xla_cost_analysis`,
`parse_hlo_costs`, `parse_collectives`).  There is no HLO here; the
counterparts count the step as it runs:

* `count_costs(fn, *args)` runs `fn` under `CostMode`, a
  `torch.distributed.tensor.debug.CommDebugMode` that lets DTensor desugar
  each op first and so sees the per-rank ops on local shards: FLOPs from
  `torch.utils.flop_counter`'s formulas on the local shapes, bytes as each
  non-view op's local inputs read once and outputs written once, and every
  functional collective DTensor issues with its result bytes and group
  size;
* `collective_stats(comm_mode, n_devices)` turns the recorded collectives
  into ring-transfer bytes, per collective with group size k:

  all-reduce:          2 * bytes * (k-1)/k        (reduce-scatter + gather)
  all-gather:          bytes * (k-1)/k            (bytes = gathered result)
  reduce-scatter:      bytes * (k-1)               (bytes = scattered result)
  all-to-all:          bytes * (k-1)/k
  collective-permute:  bytes
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 80GB HBM3 (SXM5), 700 W
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # NVLink 4, bytes/s a direction

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional-collective op name -> (kind, result bytes from the input's)
_FUNCOL = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


# ops that move no data: allocation without a write
_NO_IO = ("empty", "new_empty")


def _nbytes(t) -> float:
    if isinstance(t, torch.Tensor):
        return float(t.numel() * t.element_size())
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0.0


def _group_size(args, kwargs) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
    return 1


class CostMode(CommDebugMode):
    """CommDebugMode that also records, per rank, the FLOPs and bytes of
    every local op and the kind, result bytes and group size of every
    functional collective."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: List[Tuple[str, float, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or any(t is DTensor for t in types) \
                or isinstance(func, torch._ops.HigherOrderOperator) \
                or any(issubclass(t, FakeTensor) for t in types):
            # DTensor's own shape propagation runs each new op once on
            # fake tensors of the global shape: no work of the rank's
            return out
        packet = func._overloadpacket
        ns = getattr(packet, "_qualified_op_name", "").split("::")[0]
        if ns in ("_c10d_functional", "c10d_functional",
                  "_c10d_functional_autograd"):
            kind = _FUNCOL.get(packet.__name__)
            if kind is not None:
                self.collectives.append((kind, _nbytes(out),
                                         _group_size(args, kwargs)))
            return out
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        if not func.is_view and not packet.__name__.startswith(_NO_IO):
            self.bytes += _nbytes(out) + sum(
                _nbytes(a) for a in list(args) + list(kwargs.values()))
        return out


def count_costs(fn, *args, **kwargs):
    """-> (fn's result, `CostMode` holding `flops`, `bytes` and
    `collectives` per device) for one run of `fn(*args, **kwargs)`."""
    with CostMode() as mode:
        out = fn(*args, **kwargs)
    return out, mode


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    result_bytes: Dict[str, float]
    transfer_bytes: Dict[str, float]

    @property
    def total_transfer(self) -> float:
        return sum(self.transfer_bytes.values())


def transfer_bytes(kind: str, nbytes: float, k: int) -> float:
    """Ring-transfer bytes per device of one collective of result size
    `nbytes` over a group of `k`."""
    if kind == "all-reduce":
        return 2.0 * nbytes * (k - 1) / k
    if kind == "all-gather":
        return nbytes * (k - 1) / k
    if kind == "reduce-scatter":
        return nbytes * (k - 1)
    if kind == "all-to-all":
        return nbytes * (k - 1) / k
    return nbytes                                   # collective-permute


def collective_stats(comm_mode, n_devices: int) -> CollectiveStats:
    """The collectives `comm_mode` (a `CostMode`, or any object with a
    `collectives` list of (kind, result bytes, group size or None))
    recorded -> counts, result bytes and ring-transfer bytes by kind; a
    group size of None means all `n_devices`."""
    counts = {c: 0 for c in COLLECTIVES}
    rbytes = {c: 0.0 for c in COLLECTIVES}
    tbytes = {c: 0.0 for c in COLLECTIVES}
    for kind, nbytes, k in comm_mode.collectives:
        k = n_devices if k is None else k
        counts[kind] += 1
        rbytes[kind] += nbytes
        tbytes[kind] += transfer_bytes(kind, nbytes, k)
    return CollectiveStats(counts=counts, result_bytes=rbytes,
                           transfer_bytes=tbytes)


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / (FLOPs x chips)
    roofline_fraction: float     # ideal model compute / dominant term

    def as_dict(self):
        return dataclasses.asdict(self)


def make_roofline(*, flops_per_device: float, bytes_per_device: float,
                  collective_bytes: float, model_flops: float,
                  n_devices: int, peak_flops: float = PEAK_FLOPS,
                  hbm_bw: float = HBM_BW,
                  link_bw: float = LINK_BW) -> Roofline:
    ct = flops_per_device / peak_flops
    mt = bytes_per_device / hbm_bw
    lt = collective_bytes / link_bw
    terms = {"compute": ct, "memory": mt, "collective": lt}
    bottleneck = max(terms, key=terms.get)
    total_flops = flops_per_device * n_devices
    useful = model_flops / total_flops if total_flops else 0.0
    # how close the achievable step time (the largest term) is to the
    # ideal compute time of the model's own FLOPs
    ideal = model_flops / (n_devices * peak_flops)
    frac = ideal / max(max(terms.values()), 1e-30)
    return Roofline(flops_per_device=flops_per_device,
                    bytes_per_device=bytes_per_device,
                    collective_bytes=collective_bytes,
                    compute_s=ct, memory_s=mt, collective_s=lt,
                    bottleneck=bottleneck, model_flops=model_flops,
                    useful_ratio=useful, roofline_fraction=frac)


def model_flops_estimate(cfg, spec) -> float:
    """MODEL_FLOPS = 6*N*D for training (N = active params, D = tokens);
    2*N*D for inference steps."""
    n = cfg.active_param_count()
    if spec.kind == "train":
        return 6.0 * n * spec.seq_len * spec.global_batch
    if spec.kind == "prefill":
        return 2.0 * n * spec.seq_len * spec.global_batch
    # decode: one token per sequence
    return 2.0 * n * spec.global_batch
