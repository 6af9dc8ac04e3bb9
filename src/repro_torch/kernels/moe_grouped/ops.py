"""Public op for the MoE's grouped expert product: x [M, K] (rows sorted by
expert), w [E, K, N] and the experts' row offsets [E] -> [M, N].

A CPU or meta tensor gets the plain PyTorch version (`ref.py`: a loop over
experts), chosen by the tensor's device only; a CUDA tensor gets the
grouped GEMM (`kernel.py`) or an error, never the plain loop.  DTensors
raise: the dropless MoE runs on one card.
"""
from __future__ import annotations

from torch.distributed.tensor import DTensor

from . import kernel
from .ref import grouped_mm_ref


def grouped_mm(x, w, offs):
    """-> [M, N]: rows offs[e-1]:offs[e] of x times w[e], for every e."""
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        raise NotImplementedError(
            "the dropless MoE's grouped product runs on one device; "
            "sharded (DTensor) experts are not supported")
    kernel.check_inputs(x, w, offs)
    if x.device.type == "meta":
        return x.new_empty((x.shape[0], w.shape[2]))
    if x.device.type == "cpu":
        return grouped_mm_ref(x, w, offs)
    return kernel.grouped_mm_fwd(x, w, offs)
