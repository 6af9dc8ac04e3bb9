"""Mamba2's gate chain as one hand-written CUDA kernel for sm_90a.

`csrc/ssm_gate.cu` computes, in one launch, what `ref.gate_chain` computes
in ~14 ATen launches: from the SSD scan's output `y` and the conv's `xh`
(float32), in_proj's `z` columns, `D` and `out_norm`, all read in place
through their strides, the D skip, the SiLU gate and the RMS norm, with
the eager chain's rounding points; persistent blocks, each row staged in
shared memory by bulk copies a row ahead of its arithmetic.  An input
whose addresses do not allow those copies (`vector_ok`) is handed over as
a contiguous copy.  The source is built, loaded and launched through
`kernels/build.py`; `LAUNCHES["fused"]` counts the launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import (SM90A, CudaLibrary, Launches, aligned, cuda_only,
                     fitting, forward_only)

DTYPES = (torch.bfloat16, torch.float32)
CH = 8                     # channels a chunk (16 bytes of bf16)
MAX_D_INNER = 16384        # csrc/ssm_gate.cu: MAX_ITEMS * MAX_THREADS * CH

#: kernel launches since import (or the last `reset_launches`)
LAUNCHES = Launches("fused")
reset_launches = LAUNCHES.reset


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.ssm_gate_fwd.argtypes = [p] * 6 + [i] * 5 + [f] + [ll] * 6 + [p]
    lib.ssm_gate_fwd.restype = i


LIBRARY = CudaLibrary(
    "ssm_gate", Path(__file__).resolve().parent / "csrc" / "ssm_gate.cu",
    SM90A, _bind)


def _channels_flat(v) -> bool:
    """[B, T, H, P] whose H * P channels lie one after another."""
    return v.stride(3) == 1 and (v.shape[2] == 1 or v.stride(2) == v.shape[3])


def check_inputs(y, xh, D, z, out_norm, *, dtype) -> None:
    """Raise on what the kernel does not take: y and xh float32 [B, T, H,
    P], each with its H * P channels at unit stride; z [B, T, H P] with
    unit stride along its last dim; D [H] and out_norm [H P] contiguous;
    z, D, out_norm and `dtype` one type in `DTYPES`; P a multiple of `CH`
    (every model's is) and H P at most `MAX_D_INNER`; all on one
    device."""
    if y.dim() != 4 or xh.dim() != 4 or z.dim() != 3 or D.dim() != 1 \
            or out_norm.dim() != 1:
        raise ValueError(
            f"ssm_gate takes y, xh [B,T,H,P], z [B,T,H*P], D [H], out_norm "
            f"[H*P], got {tuple(y.shape)}, {tuple(xh.shape)}, "
            f"{tuple(z.shape)}, {tuple(D.shape)}, {tuple(out_norm.shape)}")
    b, t, h, p = y.shape
    di = h * p
    if tuple(xh.shape) != (b, t, h, p) or tuple(z.shape) != (b, t, di) \
            or tuple(D.shape) != (h,) or tuple(out_norm.shape) != (di,) \
            or h < 1 or p < 1:
        raise ValueError(
            f"shapes disagree: y {tuple(y.shape)}, xh {tuple(xh.shape)}, z "
            f"{tuple(z.shape)}, D {tuple(D.shape)}, out_norm "
            f"{tuple(out_norm.shape)}")
    if p % CH:
        raise ValueError(f"ssm_gate takes a head size P that is a multiple "
                         f"of {CH}, got {p}")
    if di > MAX_D_INNER:
        raise ValueError(f"d_inner={di} above the kernel's {MAX_D_INNER}")
    if y.dtype != torch.float32 or xh.dtype != torch.float32:
        raise ValueError(f"ssm_gate takes float32 y and xh, got {y.dtype}, "
                         f"{xh.dtype}")
    if dtype not in DTYPES or any(v.dtype != dtype for v in (z, D, out_norm)):
        raise ValueError(f"ssm_gate takes z, D, out_norm of one type in "
                         f"{DTYPES}, the output's, got "
                         f"{[v.dtype for v in (z, D, out_norm)]} -> {dtype}")
    if any(v.device != y.device for v in (xh, z, D, out_norm)):
        raise ValueError("y, xh, z, D and out_norm must lie on one device")
    if not (_channels_flat(y) and _channels_flat(xh)) or z.stride(2) != 1 \
            or not (D.is_contiguous() and out_norm.is_contiguous()):
        raise ValueError("y and xh need their H * P channels at unit stride, "
                         "z unit stride along its last dim, and D and "
                         "out_norm must be contiguous")


#: whether the kernel may read one input in place
_fits = aligned


def vector_ok(y, xh, z, out_norm) -> bool:
    """Whether the kernel may read y, xh, z and out_norm in place: every
    start 16-byte aligned, and every stride but the last (of dims longer
    than 1) of y, xh and z a positive multiple of 16 bytes (`aligned`), as
    its bulk copies and 16-byte accesses need.  Where not, `ssm_gate_fwd`
    hands it a contiguous copy of each input that does not fit.  The model
    reaches both answers: mamba2-2.7b's, zamba2-2.7b's and
    granite-4.0-h-small's layers are True, the reduced models at heads of
    64 (H = 2: in_proj's rows of 290 columns, 580 bytes of bf16) False.
    Pure Python, no launch."""
    return all(_fits(v) for v in (y, xh, z, out_norm))


#: `v` itself where the kernel may read it in place, else a contiguous copy
_fitting = fitting


def ssm_gate_fwd(y, xh, D, z, out_norm, *, eps: float, dtype):
    """CUDA tensors as `check_inputs` takes them -> out [B, T, H P], a new
    contiguous tensor of `dtype`: rms_norm(T(y + xh D) * T(silu(z)),
    out_norm, eps) with `ref.gate_chain`'s rounding points.  Forward only:
    raises when autograd would need a gradient through it."""
    check_inputs(y, xh, D, z, out_norm, dtype=dtype)
    cuda_only("ssm_gate", y.device)
    forward_only("ssm_gate", y, xh, D, z, out_norm)
    b, t, h, p = y.shape
    out = torch.empty((b, t, h * p), dtype=dtype, device=y.device)
    if b == 0 or t == 0:
        return out
    y, xh, z, out_norm = (_fitting(v) for v in (y, xh, z, out_norm))
    LIBRARY.launch(
        "ssm_gate_fwd", y.device, y.data_ptr(), xh.data_ptr(), z.data_ptr(),
        D.data_ptr(), out_norm.data_ptr(), out.data_ptr(),
        int(dtype == torch.bfloat16), b, t, h * p, p, eps, y.stride(0),
        y.stride(1), xh.stride(0), xh.stride(1), z.stride(0), z.stride(1))
    LAUNCHES.add("fused")
    return out
