"""Causal flash attention as a hand-written CUDA kernel for sm_90a.

`csrc/flash_attention.cu` holds `flash_fwd_kernel<T, D>` (T float or bf16,
D in 64/80/96/128), the counterpart of the Pallas `_flash_kernel`: one
block per (q tile, q head, batch row) on the model's [B, S, H, D] layout,
with the KV head taken as `q_head // group`, so no K/V copy is made.  The
source is compiled by `nvcc` at first use (`kernels/build.py`) and loaded
with `ctypes`; `flash_attention_fwd` launches on PyTorch's current stream
and counts its launches in `LAUNCHES["flash"]`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from ..build import SM90A, CudaLibrary

SUPPORTED_D = (64, 80, 96, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since import (or the last `reset_launches`)
LAUNCHES: Dict[str, int] = {"flash": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = [p] * 4 + [i] * 7 + [ll] * 9 + [p]
    lib.flash_attention_fwd.restype = i


LIBRARY = CudaLibrary(
    "flash_attention",
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    SM90A, _bind)


def check_inputs(q, k, v) -> None:
    """Raise on what the kernel does not take: q [B,S,H,D] and k/v
    [B,S,Hkv,D] of one type (float32 or bfloat16) on one device, H a
    multiple of Hkv, D in `SUPPORTED_D`, unit stride along D."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash attention takes [B,S,H,D] tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[:2] != (b, s) \
            or k.shape[3] != d:
        raise ValueError(f"k/v must be [B,S,Hkv,D] = [{b},{s},Hkv,{d}], got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    hkv = k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} "
                         f"KV heads")
    if d not in SUPPORTED_D:
        raise ValueError(f"head dim {d} not in {SUPPORTED_D}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16 "
                         f"inputs of one type, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k and v need unit stride along the head dim")


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """q [B,S,H,D], k/v [B,S,Hkv,D] CUDA tensors -> o [B,S,H,D], a new
    contiguous tensor of q's type.  Forward only: raises when autograd
    would need a gradient through it."""
    check_inputs(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the flash-attention kernel has no backward yet; "
                           "call it under torch.no_grad()")
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return o
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = LIBRARY.load().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h,
            k.shape[2], d, DTYPE_CODES[q.dtype], int(causal), *strides,
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES["flash"] += 1
    return o
