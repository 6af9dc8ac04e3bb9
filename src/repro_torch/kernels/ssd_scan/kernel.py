"""Mamba2 SSD chunked scan as a hand-written CUDA kernel for sm_90a.

`csrc/ssd_scan.cu` holds `ssd_fwd_kernel`, the counterpart of the Pallas
`_ssd_kernel`: one block per (column slab of P, head, batch row) walks the
chunks in order with its slice of the fp32 state in shared memory, reading
the model's [B,T,H,P] / [B,T,G,N] layouts through their strides (group
h // (H/G), no copies).  The source is compiled by `nvcc` at first use
(`kernels/build.py`) and loaded with `ctypes`; `ssd_scan_fwd` launches on
PyTorch's current stream and counts its launches in `LAUNCHES["ssd"]`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from ..build import SM90A, CudaLibrary

SUPPORTED_P = (8, 16, 32, 64)
SUPPORTED_N = (16, 32, 64, 128)
SUPPORTED_CHUNK = (16, 32, 64, 128)

#: kernel launches since import (or the last `reset_launches`)
LAUNCHES: Dict[str, int] = {"ssd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_fwd.argtypes = [p] * 6 + [i] * 7 + [ll] * 13 + [p]
    lib.ssd_scan_fwd.restype = i


LIBRARY = CudaLibrary(
    "ssd_scan", Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu",
    SM90A, _bind)


def check_inputs(xh, dt, a, bh, ch, *, chunk: int) -> None:
    """Raise on what the kernel does not take: xh [B,T,H,P], dt [B,T,H],
    a [H], bh/ch [B,T,G,N], all float32 on one device, H a multiple of G,
    T a multiple of `chunk`, P in `SUPPORTED_P`, N in `SUPPORTED_N`, chunk
    in `SUPPORTED_CHUNK`, unit stride along P and N."""
    if xh.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or bh.dim() != 4 \
            or ch.dim() != 4:
        raise ValueError(
            f"ssd_scan takes xh [B,T,H,P], dt [B,T,H], a [H], bh/ch "
            f"[B,T,G,N], got {tuple(xh.shape)}, {tuple(dt.shape)}, "
            f"{tuple(a.shape)}, {tuple(bh.shape)}, {tuple(ch.shape)}")
    b, t, h, p = xh.shape
    g, n = bh.shape[2], bh.shape[3]
    if tuple(dt.shape) != (b, t, h) or tuple(a.shape) != (h,) \
            or tuple(bh.shape[:2]) != (b, t) \
            or tuple(ch.shape) != tuple(bh.shape):
        raise ValueError(
            f"shapes disagree: xh {tuple(xh.shape)}, dt {tuple(dt.shape)}, "
            f"a {tuple(a.shape)}, bh {tuple(bh.shape)}, ch {tuple(ch.shape)}")
    if g == 0 or h % g:
        raise ValueError(f"{h} heads are not a multiple of {g} groups")
    if any(v.dtype != torch.float32 for v in (xh, dt, a, bh, ch)):
        raise ValueError(
            f"ssd_scan takes float32 inputs, got {xh.dtype}, {dt.dtype}, "
            f"{a.dtype}, {bh.dtype}, {ch.dtype}")
    if any(v.device != xh.device for v in (dt, a, bh, ch)):
        raise ValueError("xh, dt, a, bh and ch must lie on one device")
    if chunk not in SUPPORTED_CHUNK:
        raise ValueError(f"chunk {chunk} not in {SUPPORTED_CHUNK}")
    if t % chunk:
        raise ValueError(f"sequence length {t} is not a multiple of the "
                         f"chunk {chunk}")
    if p not in SUPPORTED_P:
        raise ValueError(f"head dim P={p} not in {SUPPORTED_P}")
    if n not in SUPPORTED_N:
        raise ValueError(f"state dim N={n} not in {SUPPORTED_N}")
    if xh.stride(-1) != 1 or bh.stride(-1) != 1 or ch.stride(-1) != 1:
        raise ValueError("xh, bh and ch need unit stride along P and N")


def ssd_scan_fwd(xh, dt, a, bh, ch, *, chunk: int):
    """xh [B,T,H,P], dt [B,T,H], a [H], bh/ch [B,T,G,N] float32 CUDA tensors
    -> y [B,T,H,P], a new contiguous float32 tensor (no D skip term).
    Forward only: raises when autograd would need a gradient through it."""
    check_inputs(xh, dt, a, bh, ch, chunk=chunk)
    if xh.device.type != "cuda":
        raise ValueError(f"no SSD-scan kernel for device {xh.device}")
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (xh, dt, a, bh, ch)):
        raise RuntimeError("the SSD-scan kernel has no backward yet; call "
                           "it under torch.no_grad()")
    b, t, h, p = xh.shape
    g, n = bh.shape[2], bh.shape[3]
    y = torch.empty((b, t, h, p), dtype=torch.float32, device=xh.device)
    if b == 0 or t == 0:
        return y
    strides = [v.stride(i) for v in (xh, dt, bh, ch) for i in range(3)]
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        rc = LIBRARY.load().ssd_scan_fwd(
            xh.data_ptr(), dt.data_ptr(), a.data_ptr(), bh.data_ptr(),
            ch.data_ptr(), y.data_ptr(), b, t, h, g, p, n, chunk, *strides,
            a.stride(0), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {rc}")
    LAUNCHES["ssd"] += 1
    return y
