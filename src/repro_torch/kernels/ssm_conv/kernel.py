"""Mamba2's causal conv chain as one hand-written CUDA kernel for sm_90a.

`csrc/ssm_conv.cu` computes, in one launch, what `ref.conv_chain` computes
in ~21 ATen launches: from in_proj's output `zxbcdt` [B, T, 2 di + 2 G N +
H], read in place through its strides (no split, no concat), the causal
depthwise conv of its x, B and C columns with bias and SiLU, in float32,
and dt's softplus.  The source is built, loaded and launched through
`kernels/build.py`; `LAUNCHES["fused"]` counts the launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import (SM90A, CudaLibrary, Launches, aligned, cuda_only,
                     forward_only)

SUPPORTED_K = (4,)         # conv taps: every configuration's d_conv
DTYPES = (torch.bfloat16, torch.float32)

#: kernel launches since import (or the last `reset_launches`)
LAUNCHES = Launches("fused")
reset_launches = LAUNCHES.reset


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssm_conv_fwd.argtypes = [p] * 7 + [i] * 6 + [ll] * 2 + [p]
    lib.ssm_conv_fwd.restype = i


LIBRARY = CudaLibrary(
    "ssm_conv", Path(__file__).resolve().parent / "csrc" / "ssm_conv.cu",
    SM90A, _bind)


def check_inputs(zxbcdt, conv_w, conv_b, dt_bias, *, d_inner: int,
                 gn: int) -> None:
    """Raise on what the kernel does not take: zxbcdt [B, T, 2 d_inner +
    2 gn + H] with unit stride along its last dim, conv_w [K, C] with K in
    `SUPPORTED_K` and C = d_inner + 2 gn, conv_b [C], dt_bias [H] with H
    >= 1, the three contiguous; all of one type in `DTYPES` and on one
    device."""
    if zxbcdt.dim() != 3 or conv_w.dim() != 2 or conv_b.dim() != 1 \
            or dt_bias.dim() != 1:
        raise ValueError(
            f"ssm_conv takes zxbcdt [B,T,W], conv_w [K,C], conv_b [C], "
            f"dt_bias [H], got {tuple(zxbcdt.shape)}, {tuple(conv_w.shape)},"
            f" {tuple(conv_b.shape)}, {tuple(dt_bias.shape)}")
    c, h = d_inner + 2 * gn, dt_bias.shape[0]
    if d_inner <= 0 or gn < 0 or h < 1 or conv_w.shape[1] != c \
            or tuple(conv_b.shape) != (c,) \
            or zxbcdt.shape[2] != 2 * d_inner + 2 * gn + h:
        raise ValueError(
            f"shapes disagree with d_inner={d_inner}, gn={gn}: zxbcdt "
            f"{tuple(zxbcdt.shape)}, conv_w {tuple(conv_w.shape)}, conv_b "
            f"{tuple(conv_b.shape)}, dt_bias {tuple(dt_bias.shape)}")
    if conv_w.shape[0] not in SUPPORTED_K:
        raise ValueError(f"conv width K={conv_w.shape[0]} not in "
                         f"{SUPPORTED_K}")
    args = (zxbcdt, conv_w, conv_b, dt_bias)
    if zxbcdt.dtype not in DTYPES or any(v.dtype != zxbcdt.dtype
                                         for v in args):
        raise ValueError(f"ssm_conv takes inputs of one type in {DTYPES}, "
                         f"got {[v.dtype for v in args]}")
    if any(v.device != zxbcdt.device for v in args):
        raise ValueError("zxbcdt, conv_w, conv_b and dt_bias must lie on "
                         "one device")
    if zxbcdt.stride(2) != 1 or not all(
            v.is_contiguous() for v in (conv_w, conv_b, dt_bias)):
        raise ValueError("zxbcdt needs unit stride along its last dim, and "
                         "conv_w, conv_b and dt_bias must be contiguous")


def vector_ok(zxbcdt, *, d_inner: int, gn: int) -> bool:
    """Whether the kernel may read and write 4 channels at once (8 bytes of
    bf16 or 16 of float32 in, 16 bytes out): the conv's first column of
    zxbcdt at a 16-byte-aligned address, zxbcdt's batch and time strides
    (of dims longer than 1) positive multiples of 16 bytes (`aligned`),
    and C = d_inner + 2 gn a multiple of 4 (each float32 output row
    16-byte aligned).  The model reaches both answers: mamba2-2.7b's and
    zamba2-2.7b's layers are True, the reduced models at heads of 64 (H =
    2, float32 rows of 514 columns, 2,056 bytes) False.  Pure Python, no
    launch."""
    return (d_inner + 2 * gn) % 4 == 0 and aligned(
        zxbcdt, offset=d_inner * zxbcdt.element_size())


def ssm_conv_fwd(zxbcdt, conv_w, conv_b, dt_bias, *, d_inner: int, gn: int):
    """CUDA tensors as `check_inputs` takes them -> (conv32 [B, T, C], dt
    [B, T, H]), new contiguous float32 tensors: conv32 = silu(the causal
    conv of zxbcdt's columns [d_inner, d_inner + C) with conv_w, + conv_b),
    zero history before t = 0; dt = softplus(the last H columns + dt_bias).
    Forward only: raises when autograd would need a gradient through it."""
    check_inputs(zxbcdt, conv_w, conv_b, dt_bias, d_inner=d_inner, gn=gn)
    cuda_only("ssm_conv", zxbcdt.device)
    forward_only("ssm_conv", zxbcdt, conv_w, conv_b, dt_bias)
    b, t, _ = zxbcdt.shape
    c, h = d_inner + 2 * gn, dt_bias.shape[0]
    f32 = dict(dtype=torch.float32, device=zxbcdt.device)
    out = torch.empty((b, t, c), **f32)
    dt = torch.empty((b, t, h), **f32)
    if b == 0 or t == 0:
        return out, dt
    size = zxbcdt.element_size()
    base = zxbcdt.data_ptr()
    LIBRARY.launch(
        "ssm_conv_fwd", zxbcdt.device, base + d_inner * size,
        base + (2 * d_inner + 2 * gn) * size, conv_w.data_ptr(),
        conv_b.data_ptr(), dt_bias.data_ptr(), out.data_ptr(), dt.data_ptr(),
        int(zxbcdt.dtype == torch.bfloat16),
        int(vector_ok(zxbcdt, d_inner=d_inner, gn=gn)), b, t, c, h,
        zxbcdt.stride(0), zxbcdt.stride(1))
    LAUNCHES.add("fused")
    return out, dt
