"""TRIM mapspace scoring as a hand-written CUDA kernel for sm_90a.

`csrc/mapspace_eval.cu` holds one `__global__` template,
`score_kernel<N_MEM>`, one thread per mapping row, reading the packed
mapspace (`factors`, `rank` [B, L, 7] int32, `store` [B, Lm, 3] bool) and
one float64 record of constants per (architecture, workload) job
(`ref.REC_FIELDS`); it writes cycles and energy (float32) and validity
(bool) per row:

  * `mapspace_eval_fwd`       — one job (the counterpart of the Pallas
    `_score_kernel`);
  * `mapspace_eval_multi_fwd` — rows of several jobs sharing a `BatchSig`,
    job j owning rows offsets[j]:offsets[j+1], in one launch
    (`_score_kernel_multi`).

The source is built, loaded and launched through `kernels/build.py` (one
library for every layout).  Each wrapper checks its inputs, launches and
counts its launches in `LAUNCHES`.  A wrapper given CPU tensors computes
the plain PyTorch version (`ref.py`) instead — chosen by the tensors'
device only; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import ref
from ..build import CudaLibrary, Launches, aligned, cuda_only

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
SUPPORTED_N_MEM = (2, 3)

#: kernel launches per variant since import (or the last `reset_launches`);
#: exact under threads (a DSE service scores several jobs at once)
LAUNCHES = Launches("single", "multi")
reset_launches = LAUNCHES.reset


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mapspace_eval_score.argtypes = ([p] * 5 + [i] * 7 + [ctypes.c_uint]
                                        + [i] * 2 + [p] * 4)
    lib.mapspace_eval_score.restype = i
    lib.mapspace_eval_job_layout.argtypes = [p]
    lib.mapspace_eval_job_layout.restype = i
    offsets = (ctypes.c_int * len(ref.REC_FIELDS))()
    n = lib.mapspace_eval_job_layout(ctypes.addressof(offsets))
    if n != ref.REC_DOUBLES or list(offsets) != [
            ref.REC_OFFSETS[name][0] for name, _ in ref.REC_FIELDS]:
        raise RuntimeError("JobRec layout differs from ref.REC_FIELDS")


LIBRARY = CudaLibrary(
    "mapspace_eval",
    Path(__file__).resolve().parent / "csrc" / "mapspace_eval.cu",
    NVCC_FLAGS, _bind)


def _check(factors, rank, store, jobs, offsets, layout: ref.Layout):
    """Device, dtype, shape and contiguity checks shared by both wrappers
    (the kernel indexes rows by these shapes); -> (rows, device)."""
    n_mem, L = len(layout.mem_idx), layout.n_levels
    if n_mem not in SUPPORTED_N_MEM:
        raise ValueError(f"kernel supports {SUPPORTED_N_MEM} memory levels, "
                         f"got {n_mem}")
    if L > ref.MAX_LEVELS or L != n_mem + len(layout.rout_idx):
        raise ValueError(f"kernel supports up to {ref.MAX_LEVELS} memory and "
                         f"routing levels, got layout {layout}")
    b = factors.shape[0]
    want = [("factors", factors, (b, L, 7), torch.int32),
            ("rank", rank, (b, L, 7), torch.int32),
            ("store", store, (b, n_mem, 3), torch.bool),
            ("jobs", jobs, tuple(jobs.shape[:-1]) + (ref.REC_DOUBLES,),
             torch.float64)]
    if offsets is not None:
        want.append(("offsets", offsets, (jobs.shape[0] + 1,), torch.int32))
    dev = factors.device
    for name, t, shape, dtype in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"kernel input {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"kernel input {name} must be a contiguous "
                             f"{dtype} tensor on {dev}")
    return b, dev


def _launch(factors, rank, store, jobs, offsets, layout: ref.Layout, b: int,
            dev):
    cuda_only("mapspace_eval", dev)
    for name, t in (("factors", factors), ("rank", rank), ("store", store),
                    ("jobs", jobs)):
        if not aligned(t, dims=()):    # its inputs staged by 16-byte copies
            raise ValueError(f"kernel input {name} must start on a "
                             f"16-byte boundary")
    cycles = torch.empty((b,), dtype=torch.float32, device=dev)
    energy = torch.empty((b,), dtype=torch.float32, device=dev)
    valid = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return cycles, energy, valid
    mem = list(layout.mem_idx) + [-1] * (ref.MAX_MEM - len(layout.mem_idx))
    rout_mask = sum(1 << r for r in layout.rout_idx)
    n_jobs = 1 if offsets is None else offsets.shape[0] - 1
    LIBRARY.launch(
        "mapspace_eval_score", dev, factors.data_ptr(), rank.data_ptr(),
        store.data_ptr(), jobs.data_ptr(),
        None if offsets is None else offsets.data_ptr(), n_jobs, b,
        layout.n_levels, len(layout.mem_idx), *mem, rout_mask,
        int(layout.depthwise), int(layout.has_weight), cycles.data_ptr(),
        energy.data_ptr(), valid.data_ptr())
    return cycles, energy, valid


def mapspace_eval_fwd(factors, rank, store, job, *, layout: ref.Layout):
    """One job: `job` [REC_DOUBLES] float64.  -> (cycles [B] float32,
    energy [B] float32, valid [B] bool) on the inputs' device."""
    b, dev = _check(factors, rank, store, job, None, layout)
    if job.dim() != 1:
        raise ValueError("mapspace_eval_fwd takes one job record")
    if dev.type == "cpu":
        return ref.score_ref(factors, rank, store, job, layout=layout)
    out = _launch(factors, rank, store, job, None, layout, b, dev)
    if b:
        LAUNCHES.add("single")
    return out


def mapspace_eval_multi_fwd(factors, rank, store, jobs, offsets, *,
                            layout: ref.Layout):
    """Rows of `jobs` [J, REC_DOUBLES] float64, job j owning rows
    offsets[j]:offsets[j+1] (`offsets` [J+1] int32, from 0 to B).
    -> (cycles [B], energy [B], valid [B])."""
    b, dev = _check(factors, rank, store, jobs, offsets, layout)
    if jobs.dim() != 2 or jobs.shape[0] < 1:
        raise ValueError("mapspace_eval_multi_fwd takes [J, REC] records")
    if dev.type == "cpu":
        return ref.score_multi_ref(factors, rank, store, jobs, offsets,
                                   layout=layout)
    out = _launch(factors, rank, store, jobs, offsets, layout, b, dev)
    if b:
        LAUNCHES.add("multi")
    return out
