"""The grouped expert product on the card: PyTorch's grouped GEMM
(`torch._grouped_mm`, a CUTLASS grouped GEMM for bf16 on sm_90), one launch
for every group at once, the groups' rows delimited by offsets that stay
on the device (no host sync, no padding).  A library call, as the
projections' cuBLAS GEMMs are; `grouped_mm_fwd` counts its launches in
`LAUNCHES["grouped"]`.
"""
from __future__ import annotations

from typing import Dict

import torch

#: bytes: the grouped GEMM's alignment of base pointers and row strides
ALIGN = 16

#: launches since import (or the last `reset_launches`)
LAUNCHES: Dict[str, int] = {"grouped": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_inputs(x, w, offs) -> None:
    """Raise unless x [M, K], w [G, K, N] and offs [G] (int32) lie on one
    device, x and w of one type, x and w row-major."""
    if x.dim() != 2 or w.dim() != 3 or offs.dim() != 1:
        raise ValueError(f"grouped_mm takes x [M,K], w [G,K,N], offs [G], "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(offs.shape)}")
    if w.shape[1] != x.shape[1] or offs.shape[0] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and offs "
                         f"{tuple(offs.shape)} do not match")
    if offs.dtype != torch.int32:
        raise ValueError(f"offs must be int32, got {offs.dtype}")
    if w.dtype != x.dtype:
        raise ValueError(f"x and w differ in type: {x.dtype}, {w.dtype}")
    if w.device != x.device or offs.device != x.device:
        raise ValueError("x, w and offs must lie on one device")
    if x.stride(-1) != 1 or w.stride(-1) != 1:
        raise ValueError("x and w must be row-major")


def grouped_mm_fwd(x, w, offs) -> torch.Tensor:
    """x [M, K] bf16 CUDA, rows sorted by group; w [G, K, N] bf16; offs
    [G] int32 on the device -> [M, N] bf16.  Forward only."""
    check_inputs(x, w, offs)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped GEMM for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the grouped GEMM takes bfloat16, got {x.dtype}")
    for t in (x, w):
        if t.data_ptr() % ALIGN or any(
                st * t.element_size() % ALIGN for st in t.stride()[:-1]):
            raise ValueError(f"grouped_mm needs {ALIGN}-byte aligned "
                             f"pointers and row strides, got "
                             f"{tuple(t.stride())}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("the grouped expert product has no backward "
                           "here; call it under torch.no_grad()")
    out = torch._grouped_mm(x, w, offs=offs)
    LAUNCHES["grouped"] += 1
    return out
