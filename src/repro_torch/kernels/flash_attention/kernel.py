"""Causal flash attention as hand-written CUDA kernels for sm_90a.

`csrc/flash_attention.cu` holds two counterparts of the Pallas
`_flash_kernel`, both on the model's [B, S, H, D] layout with the KV head
taken as `q_head // group`, so no K/V copy is made:

* `flash_fwd_tc_kernel<D>` (route "wgmma"): bf16 at D 64 and 128, both
  products on the tensor cores (`wgmma`), K/V tiles through TMA into a
  two-stage ring, a producer warpgroup and two consumer warpgroups;
* `flash_fwd_kernel<T, D>` (route "simt"): float32 at every D and bf16 at
  D 80 and 96, products in fp32 on the CUDA cores.

`choose_route` picks one from the inputs' type, head dim and alignment
before any launch; nothing falls back from one to the other.  The source is
compiled by `nvcc` at first use (`kernels/build.py`) and loaded with
`ctypes`; `flash_attention_fwd` launches on PyTorch's current stream and
counts its launches: `LAUNCHES["flash"]` every launch,
`LAUNCHES["flash_wgmma"]` those of the tensor-core route.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from ..build import SM90A, CudaLibrary

SUPPORTED_D = (64, 80, 96, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the routes, by the code the C entry takes
ROUTES = {"simt": 0, "wgmma": 1}
WGMMA_D = (64, 128)        # whole 128-byte swizzle panels of bf16
TMA_ALIGN = 16             # bytes: TMA's base address and stride unit

#: kernel launches since import (or the last `reset_launches`)
LAUNCHES: Dict[str, int] = {"flash": 0, "flash_wgmma": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = [p] * 4 + [i] * 8 + [ll] * 9 + [p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_tc_smem_bytes.argtypes = [i]
    lib.flash_attention_tc_smem_bytes.restype = i


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


def choose_route(q, k, v) -> str:
    """The kernel that takes these inputs: "wgmma" for bfloat16 at D 64 or
    128 whose base pointers and strides (of every dimension longer than 1)
    are positive multiples of 16 bytes, as TMA reads them; "simt" for
    everything else `check_inputs` accepts.  Pure Python, no launch."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in WGMMA_D:
        return "simt"
    for t in (q, k, v):
        if t.data_ptr() % TMA_ALIGN:
            return "simt"
        for n, st in zip(t.shape[:3], t.stride()[:3]):
            if n > 1 and (st <= 0 or st * t.element_size() % TMA_ALIGN):
                return "simt"
    return "wgmma"


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """q [B,S,H,D], k/v [B,S,Hkv,D] CUDA tensors -> o [B,S,H,D], a new
    contiguous tensor of q's type, from the kernel `choose_route` names.
    Forward only: raises when autograd would need a gradient through it."""
    check_inputs(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the flash-attention kernel has no backward yet; "
                           "call it under torch.no_grad()")
    route = choose_route(q, k, v)
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return o
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = LIBRARY.load().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h,
            k.shape[2], d, DTYPE_CODES[q.dtype], int(causal), ROUTES[route],
            *strides, stream)
    if rc < 0:
        raise RuntimeError(f"flash_attention ({route}): the driver refused "
                           f"a tensor map: CUresult {-rc}")
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"({route}): cudaError {rc}")
    LAUNCHES["flash"] += 1
    if route == "wgmma":
        LAUNCHES["flash_wgmma"] += 1
    return o
