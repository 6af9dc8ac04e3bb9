"""The grouped expert product on the card: PyTorch's grouped GEMM
(`torch._grouped_mm`, a CUTLASS grouped GEMM for bf16 on sm_90), one launch
for every group at once, the groups' rows delimited by offsets that stay
on the device (no host sync, no padding).  A library call, as the
projections' cuBLAS GEMMs are; `grouped_mm_fwd` counts its launches in
`LAUNCHES["grouped"]`.
"""
from __future__ import annotations

import torch

from ..build import Launches, aligned, cuda_only, forward_only

#: launches since import (or the last `reset_launches`)
LAUNCHES = Launches("grouped")
reset_launches = LAUNCHES.reset


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
    cuda_only("grouped GEMM", x.device)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the grouped GEMM takes bfloat16, got {x.dtype}")
    for t in (x, w):
        if not aligned(t):
            raise ValueError(f"grouped_mm needs 16-byte aligned pointers "
                             f"and row strides, got {tuple(t.stride())}")
    forward_only("grouped GEMM", x, w)
    out = torch._grouped_mm(x, w, offs=offs)
    LAUNCHES.add("grouped")
    return out
