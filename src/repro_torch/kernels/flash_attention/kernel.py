"""Causal flash attention as hand-written CUDA kernels for sm_90a.

`csrc/flash_attention.cu` holds two counterparts of the Pallas
`_flash_kernel`, both on the model's [B, S, H, D] layout with the KV head
taken as `q_head // group`, so no K/V copy is made:

* `flash_fwd_tc_kernel<D>` (route "wgmma"): bf16 at every D whose
  pointers and strides TMA can read, both products on the tensor cores
  (`wgmma`), K/V tiles through TMA into a two-stage ring, a producer
  warpgroup and two consumer warpgroups; D 80 and 96 are read as two
  128-byte panels, the second padded with TMA's zero fill;
* `flash_fwd_kernel<T, D>` (route "simt"): float32 at every D and bf16 in
  a layout TMA cannot read, products in fp32 on the CUDA cores.

`choose_route` picks one from the inputs' type and alignment before any
launch; nothing falls back from one to the other.  The source is built,
loaded and launched through `kernels/build.py`; `LAUNCHES["flash"]`
counts every launch, `LAUNCHES["flash_wgmma"]` those of the tensor-core
route.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...configs.base import inv_sqrt_f32
from ..build import (SM90A, CudaLibrary, Launches, aligned, cuda_only,
                     forward_only)

SUPPORTED_D = (64, 80, 96, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the routes, by the code the C entry takes
ROUTES = {"simt": 0, "wgmma": 1}

#: kernel launches since import (or the last `reset_launches`)
LAUNCHES = Launches("flash", "flash_wgmma")
reset_launches = LAUNCHES.reset


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = [p] * 4 + [i] * 8 + [ll] * 9 \
        + [ctypes.c_float, p]
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
    """The kernel that takes inputs `check_inputs` accepts: "wgmma" for
    bfloat16 (at every D of `SUPPORTED_D`) whose base pointers and strides
    (of every dimension longer than 1) are positive multiples of 16 bytes,
    as TMA reads them; "simt" for everything else.  Pure Python, no
    launch."""
    if q.dtype == torch.bfloat16 and all(aligned(t) for t in (q, k, v)):
        return "wgmma"
    return "simt"


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        scale: float = None):
    """q [B,S,H,D], k/v [B,S,Hkv,D] CUDA tensors -> o [B,S,H,D], a new
    contiguous tensor of q's type, from the kernel `choose_route` names,
    the softmax taken of the logits times `scale` (None: 1/sqrt(D) in
    float32, `inv_sqrt_f32`).  Forward only: raises when autograd would
    need a gradient through it."""
    check_inputs(q, k, v)
    scale = inv_sqrt_f32(q.shape[3]) if scale is None else float(scale)
    if not scale > 0:
        raise ValueError(f"the softmax scale must be positive, got {scale}")
    cuda_only("flash-attention", q.device)
    forward_only("flash-attention", q, k, v)
    route = choose_route(q, k, v)
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return o
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    LIBRARY.launch(
        "flash_attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), b, s, h, k.shape[2], d,
        DTYPE_CODES[q.dtype], int(causal), ROUTES[route], *strides, scale)
    LAUNCHES.add("flash")
    if route == "wgmma":
        LAUNCHES.add("flash_wgmma")
    return o
