"""TRIM mapspace scoring as a hand-written CUDA kernel for sm_90a.

`csrc/mapspace_eval.cu` holds one `__global__` template,
`score_kernel<PER_ROW, N_MEM>`, one thread per mapping row:

  * `mapspace_eval_fwd`       — one (architecture, workload) pair; the
    hardware constants travel by value in a small struct (the counterpart
    of the Pallas `_score_kernel`, which baked them statically);
  * `mapspace_eval_multi_fwd` — per-row constants (zsf [B, L1, 3],
    mem_par [B, Lm, 3], hw_row [B, 4]) so rows of any architectures
    sharing a `BatchSig` fuse into one launch (`_score_kernel_multi`).

The source is compiled by `nvcc` at first use (`kernels/build.py`; one
library for every architecture) and loaded with `ctypes`.  Each
wrapper launches on PyTorch's current stream and counts its launches in
`LAUNCHES`.  A wrapper given CPU tensors computes the plain PyTorch version
(`ref.py`) instead — chosen by the tensors' device only; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from . import ref
from ..build import CudaLibrary

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
SUPPORTED_N_MEM = (2, 3)
MAX_MEM = 3

#: kernel launches per variant since import (or the last `reset_launches`)
LAUNCHES: Dict[str, int] = {"single": 0, "multi": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mapspace_eval_single.argtypes = [p] * 15 + [i, i, p]
    lib.mapspace_eval_single.restype = i
    lib.mapspace_eval_multi.argtypes = [p] * 17 + [i, i, p]
    lib.mapspace_eval_multi.restype = i
    lib.mapspace_eval_hw_floats.restype = i
    if lib.mapspace_eval_hw_floats() != 6 * MAX_MEM + 6:
        raise RuntimeError("HwConst layout differs from the host's")


LIBRARY = CudaLibrary(
    "mapspace_eval",
    Path(__file__).resolve().parent / "csrc" / "mapspace_eval.cu",
    NVCC_FLAGS, _bind)


def hw_consts(static: dict) -> np.ndarray:
    """Single-architecture constants in the kernel's `HwConst` order."""
    n_mem = static["n_mem"]
    hc = np.zeros((6 * MAX_MEM + 6,), np.float32)
    zsf = hc[:3 * MAX_MEM].reshape(MAX_MEM, 3)
    for j in range(n_mem):
        if static["zs_parent"][j]:
            zsf[j] = static["zf"]
        else:
            zsf[j] = 1.0
    o = 3 * MAX_MEM
    hc[o:o + n_mem] = static["mem_bw"]
    hc[o + MAX_MEM:o + MAX_MEM + n_mem] = static["e_read"]
    hc[o + 2 * MAX_MEM:o + 2 * MAX_MEM + n_mem] = static["e_write"]
    hc[6 * MAX_MEM:] = (static["macs"], static["macs_per_pe"],
                        static["pipeline"],
                        static["eff_macs"] * static["mac_energy"],
                        static["leak_rate"], static["noc_bw"])
    return hc


def _check(arrays, n_mem: int):
    """Device, dtype, shape and contiguity checks shared by both
    wrappers (the kernel indexes rows by these shapes); -> (rows,
    device)."""
    if n_mem not in SUPPORTED_N_MEM:
        raise ValueError(f"kernel supports {SUPPORTED_N_MEM} memory levels, "
                         f"got {n_mem}")
    b, s = arrays[0].shape[0], 7 * n_mem
    shapes = ([(b, s)] * 5 + [(b, n_mem, 3)] * 2 + [(b, n_mem, s)]
              + [(b, n_mem)] * 2 + [(b, n_mem, 3), (b, n_mem)]
              + [(b, n_mem, 3), (b, n_mem, 3), (b, 4)])[:len(arrays)]
    dev = arrays[0].device
    for i, (a, shape) in enumerate(zip(arrays, shapes)):
        if tuple(a.shape) != shape:
            raise ValueError(f"kernel input {i} has shape "
                             f"{tuple(a.shape)}, expected {shape}")
        if a.device != dev or a.dtype != torch.float32 \
                or not a.is_contiguous():
            raise ValueError("kernel inputs must be contiguous float32 "
                             "tensors on one device")
    return b, dev


def _launch(fn, arrays, extra, b: int, n_mem: int, dev):
    cycles = torch.empty((b,), dtype=torch.float32, device=dev)
    energy = torch.empty((b,), dtype=torch.float32, device=dev)
    if b == 0:
        return cycles, energy
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(*[a.data_ptr() for a in arrays], *extra,
                cycles.data_ptr(), energy.data_ptr(), b, n_mem, stream)
    if rc != 0:
        raise RuntimeError(f"mapspace_eval kernel launch failed: "
                           f"cudaError {rc}")
    return cycles, energy


def mapspace_eval_fwd(bounds, cum, rel_i, rel_w, rel_o, tw_u, tw_p, fresh,
                      ia, ib, noc_e, noc_m, *, static: dict):
    """All tensors share the leading mapping axis B.  -> (cycles [B],
    energy [B]) float32 on the inputs' device."""
    arrays = [bounds, cum, rel_i, rel_w, rel_o, tw_u, tw_p, fresh, ia, ib,
              noc_e, noc_m]
    n_mem = static["n_mem"]
    b, dev = _check(arrays, n_mem)
    if dev.type == "cpu":
        return ref.score_ref(*arrays, static=static)
    if dev.type != "cuda":
        raise ValueError(f"no mapspace_eval kernel for device {dev}")
    hc = hw_consts(static)
    out = _launch(LIBRARY.load().mapspace_eval_single, arrays, [hc.ctypes.data],
                  b, n_mem, dev)
    if b:
        LAUNCHES["single"] += 1
    return out


def mapspace_eval_multi_fwd(bounds, cum, rel_i, rel_w, rel_o, tw_u, tw_p,
                            fresh, ia, ib, noc_e, noc_m, zsf, mem_par,
                            hw_row):
    """Multi-architecture forward: the twelve per-mapping tensors plus
    per-row hardware tensors.  -> (cycles [B], energy [B])."""
    arrays = [bounds, cum, rel_i, rel_w, rel_o, tw_u, tw_p, fresh, ia, ib,
              noc_e, noc_m, zsf, mem_par, hw_row]
    n_mem = mem_par.shape[1]
    b, dev = _check(arrays, n_mem)
    if dev.type == "cpu":
        return ref.score_multi_ref(*arrays)
    if dev.type != "cuda":
        raise ValueError(f"no mapspace_eval kernel for device {dev}")
    out = _launch(LIBRARY.load().mapspace_eval_multi, arrays, [], b, n_mem, dev)
    if b:
        LAUNCHES["multi"] += 1
    return out
