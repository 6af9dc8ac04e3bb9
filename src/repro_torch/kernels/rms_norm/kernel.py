"""The RMS norm as one hand-written CUDA kernel for sm_90a.

`csrc/rms_norm.cu` computes in one launch what `ref.rms_norm` computes in
~9 ATen launches: x [..., d] (bf16 or float32, unit stride along d, row
strides of 16-byte multiples) read once, its rows normalised in float32
with the eager chain's rounding points and scaled by the weight (of x's
type), the output written once, a new contiguous tensor of x's type, all
in 16-byte accesses.  The wrapper hands it a contiguous copy of an x or a
weight it may not read in place (`vector_ok`); no model's norm needs one.
The source is built, loaded and launched through `kernels/build.py`;
`LAUNCHES["fused"]` counts the launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import (SM90A, CudaLibrary, Launches, aligned, cuda_only,
                     fitting, forward_only)

DTYPES = (torch.bfloat16, torch.float32)
MAX_D = 16384              # csrc/rms_norm.cu: 32 values a thread, 512 threads

#: kernel launches since import (or the last `reset_launches`)
LAUNCHES = Launches("fused")
reset_launches = LAUNCHES.reset


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.rms_norm_fwd.argtypes = [p] * 3 + [i] + [ll] * 4 + [i, f, p]
    lib.rms_norm_fwd.restype = i


LIBRARY = CudaLibrary(
    "rms_norm", Path(__file__).resolve().parent / "csrc" / "rms_norm.cu",
    SM90A, _bind)


def check_inputs(x, weight) -> None:
    """Raise on what the kernel does not take: x [..., d] with unit stride
    along d (unless it has no rows), weight [d] contiguous and of x's
    type, a type in `DTYPES`, 1 <= d <= `MAX_D` with d a multiple of 16
    bytes' values (8 bf16, 4 float32), both on one device.  Every model's
    norm fits: its d is a multiple of 32, its weight of its type."""
    if x.dim() < 1 or weight.dim() != 1:
        raise ValueError(f"rms_norm takes x [..., d] and weight [d], got "
                         f"{tuple(x.shape)}, {tuple(weight.shape)}")
    d = x.shape[-1]
    if weight.shape[0] != d:
        raise ValueError(f"a weight of length {weight.shape[0]} for rows "
                         f"of {d}")
    if x.dtype not in DTYPES or weight.dtype != x.dtype:
        raise ValueError(f"rms_norm takes x and weight of one of the types "
                         f"{DTYPES}, got {x.dtype}, {weight.dtype}")
    values = 16 // x.element_size()
    if not 1 <= d <= MAX_D or d % values:
        raise ValueError(f"d={d} outside the kernel's 1..{MAX_D} or not a "
                         f"multiple of {values}")
    if weight.device != x.device:
        raise ValueError("x and weight must lie on one device")
    if (x.numel() and x.stride(-1) != 1) or weight.stride(0) != 1:
        raise ValueError("x needs unit stride along its last dim, and the "
                         "weight must be contiguous")


def _rows(x):
    """x as [outer, inner, d]: a view, as every caller's x allows (a copy
    only where more than two leading dims do not merge)."""
    if x.dim() == 1:
        return x[None, None]
    if x.dim() == 2:
        return x[None]
    return x.flatten(0, -3)


def vector_ok(x, weight) -> bool:
    """Whether the kernel may read x [..., d] and the weight in place:
    the starts of both and x's row strides (of dims longer than 1)
    multiples of 16 bytes (`aligned`).  Where not, `rms_norm_fwd` hands it
    a contiguous copy.  Every model's norm of the residual stream and
    MLA's latent norms (`c_kv` a view in rows of kv_lora_rank +
    qk_rope_dim) are True.  Pure Python, no launch."""
    return aligned(x) and aligned(weight)


def rms_norm_fwd(x, weight, *, eps: float):
    """CUDA tensors as `check_inputs` takes them -> the normed x, a new
    contiguous tensor of x's type and shape, with `ref.rms_norm`'s
    rounding points.  No rows: no launch.  Forward only: raises when
    autograd would need a gradient through it."""
    check_inputs(x, weight)
    cuda_only("rms_norm", x.device)
    forward_only("rms_norm", x, weight)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    rows, weight = fitting(_rows(x)), fitting(weight)
    LIBRARY.launch(
        "rms_norm_fwd", x.device, rows.data_ptr(), weight.data_ptr(),
        out.data_ptr(), int(x.dtype == torch.bfloat16), rows.shape[0],
        rows.shape[1], rows.stride(0), rows.stride(1), x.shape[-1], eps)
    LAUNCHES.add("fused")
    return out
