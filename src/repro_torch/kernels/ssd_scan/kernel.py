"""Mamba2 SSD chunked scan as hand-written CUDA kernels for sm_90a.

`csrc/ssd_scan.cu` holds two counterparts of the Pallas `_ssd_kernel`,
both reading the model's [B,T,H,P] / [B,T,G,N] layouts through their
strides (group h // (H/G), no copies):

* route "tc": the SSD block decomposition in five launches (cumulative
  sums in double, C B^T once per group, chunk states, state passing, chunk
  outputs), every product as three TF32 passes on the tensor cores
  (`wgmma`), tiles by `cp.async` into two-stage rings; scratch allocated
  here with `torch.empty`;
* route "simt": `ssd_fwd_kernel`, one block per (column slab of P, head,
  batch row) walking the chunks in order with its slice of the fp32 state
  in shared memory, on the CUDA cores.

`choose_route` picks one from the shapes and alignment before any launch;
nothing falls back from one to the other.  The source is compiled by `nvcc`
at first use (`kernels/build.py`) and loaded with `ctypes`; `ssd_scan_fwd`
launches on PyTorch's current stream and counts op calls in
`LAUNCHES["ssd"]`, those on route "tc" also in `LAUNCHES["ssd_tc"]`.
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
#: what the tensor-core route takes (a 64-row `wgmma` tile of y^T needs
#: P >= 32; a 32-wide K panel of C and B needs N >= 32 and chunk >= 64)
TC_P, TC_N, TC_CHUNK = (32, 64), (32, 64, 128), (64, 128)
ROUTES = ("simt", "tc")
CP_ASYNC_ALIGN = 16        # bytes: cp.async's source alignment

#: op calls since import (or the last `reset_launches`): every call in
#: "ssd", those on route "tc" also in "ssd_tc"; "ssd_steps" counts calls of
#: the test-only `ssd_tc_steps`
LAUNCHES: Dict[str, int] = {"ssd": 0, "ssd_tc": 0, "ssd_steps": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_fwd.argtypes = [p] * 6 + [i] * 7 + [ll] * 13 + [p]
    lib.ssd_scan_fwd.restype = i
    lib.ssd_scan_tc.argtypes = [p] * 10 + [i] * 7 + [ll] * 13 + [i, p]
    lib.ssd_scan_tc.restype = i
    lib.ssd_tc_smem_bytes.argtypes = [i] * 4
    lib.ssd_tc_smem_bytes.restype = i


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


def choose_route(xh, dt, a, bh, ch, *, chunk: int) -> str:
    """The kernel that takes these inputs (as `check_inputs` accepts
    them): "tc" for chunk in `TC_CHUNK`, P in `TC_P` and N in `TC_N` with
    xh, bh and ch at 16-byte-aligned addresses and strides (of every
    dimension longer than 1), as `cp.async` reads them; "simt" for the
    rest.  Pure Python, no launch."""
    p, n = xh.shape[3], bh.shape[3]
    if chunk not in TC_CHUNK or p not in TC_P or n not in TC_N:
        return "simt"
    for t in (xh, bh, ch):
        if t.data_ptr() % CP_ASYNC_ALIGN:
            return "simt"
        for size, st in zip(t.shape[:3], t.stride()[:3]):
            if size > 1 and (st <= 0
                             or st * t.element_size() % CP_ASYNC_ALIGN):
                return "simt"
    return "tc"


def _check_launch(xh, dt, a, bh, ch, chunk: int) -> None:
    check_inputs(xh, dt, a, bh, ch, chunk=chunk)
    if xh.device.type != "cuda":
        raise ValueError(f"no SSD-scan kernel for device {xh.device}")
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (xh, dt, a, bh, ch)):
        raise RuntimeError("the SSD-scan kernel has no backward yet; call "
                           "it under torch.no_grad()")


def _launch_tc(xh, dt, a, bh, ch, chunk: int, last_step: int):
    """The tensor-core route's launches up to `last_step` -> (y, scratch
    {"cs": the in-chunk cumulative sums of dA as float pairs hi + lo,
    "dt": dt transposed, "cb", "states"})."""
    b, t, h, p = xh.shape
    g, n = bh.shape[2], bh.shape[3]
    nc = t // chunk
    f32 = dict(dtype=torch.float32, device=xh.device)
    y = torch.empty((b, t, h, p), **f32)
    scratch = dict(
        cs=torch.empty((b, h, t, 2), **f32),
        dt=torch.empty((b, h, t), **f32),
        cb=torch.empty((b, nc, g, chunk, chunk), **f32),
        states=torch.empty((b, max(nc - 1, 0), h, n, p), **f32))
    if b == 0 or t == 0:
        return y, scratch
    strides = [v.stride(i) for v in (xh, dt, bh, ch) for i in range(3)]
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        rc = LIBRARY.load().ssd_scan_tc(
            xh.data_ptr(), dt.data_ptr(), a.data_ptr(), bh.data_ptr(),
            ch.data_ptr(), y.data_ptr(),
            *(v.data_ptr() for v in scratch.values()), b, t, h, g, p, n,
            chunk, *strides, a.stride(0), last_step, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed (tc): cudaError "
                           f"{rc}")
    return y, scratch


def ssd_scan_fwd(xh, dt, a, bh, ch, *, chunk: int, route=None):
    """xh [B,T,H,P], dt [B,T,H], a [H], bh/ch [B,T,G,N] float32 CUDA tensors
    -> y [B,T,H,P], a new contiguous float32 tensor (no D skip term), from
    the kernel `choose_route` names; `route` ("tc" or "simt") overrides
    that choice for the tests and `chip_smoke.py` only, and raises where the
    route does not take the inputs.  Forward only: raises when autograd
    would need a gradient through it."""
    _check_launch(xh, dt, a, bh, ch, chunk)
    chosen = choose_route(xh, dt, a, bh, ch, chunk=chunk)
    if route is None:
        route = chosen
    elif route not in ROUTES:
        raise ValueError(f"route {route!r} not in {ROUTES}")
    elif route == "tc" and chosen != "tc":
        raise ValueError("the tensor-core route does not take these inputs "
                         "(see choose_route)")
    if route == "tc":
        y = _launch_tc(xh, dt, a, bh, ch, chunk, 4)[0]
        LAUNCHES["ssd"] += 1
        LAUNCHES["ssd_tc"] += 1
        return y
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


def ssd_tc_steps(xh, dt, a, bh, ch, *, chunk: int, last_step: int = 4):
    """Test-only entry: the tensor-core route's launches up to `last_step`
    (1 C B^T, 2 chunk states, 3 state passing, 4 outputs) -> {"y", "cs",
    "dt", "cb", "states"}: the scratch tensors as those steps left them.
    "cb" holds, in each 64-row tile m of a chunk, the columns j < 64 (m + 1)
    (the rest is left unwritten: step 4 needs j <= i only); "states"[:, c]
    holds chunk c's own state after step 2 and the state entering chunk
    c + 1 after step 3; "y" is written by step 4 only."""
    _check_launch(xh, dt, a, bh, ch, chunk)
    if choose_route(xh, dt, a, bh, ch, chunk=chunk) != "tc":
        raise ValueError("the tensor-core route does not take these inputs "
                         "(see choose_route)")
    if last_step not in (1, 2, 3, 4):
        raise ValueError(f"last_step {last_step} not in 1..4")
    y, scratch = _launch_tc(xh, dt, a, bh, ch, chunk, last_step)
    LAUNCHES["ssd_steps"] += 1
    return dict(y=y, **scratch)
