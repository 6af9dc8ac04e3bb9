"""Build, load and launch the port's CUDA kernels.

Each kernel source is one `.cu` file with a plain C interface.  `nvcc`
compiles it for sm_90a into a shared library under
`build/repro_torch_kernels/` at the repository root (git-ignored), at first
use and never at import; the file name carries a hash of the source and
the flags, so an edit rebuilds.  The compiler's register/spill report
(`-Xptxas -v`) is kept beside it as `.log`.  The library is loaded with
`ctypes` and bound once by the kernel module's `bind` callback.

What every kernel wrapper (`kernels/<k>/kernel.py`) shares lives here too:
`CudaLibrary.launch` (the call on PyTorch's current stream and its return
code), `Launches` (the launch counters, behind one lock), `aligned` (the
16-byte rule of TMA, `cp.async` and vector accesses), `fitting` (a copy
of what breaks it) and the guards
`cuda_only` and `forward_only`.  `needs_grad` is the one rule by which a
Mamba2 op (`ssm_conv`, `ssd_scan`, `ssm_gate`) takes its plain version:
while autograd records a gradient through an input, whatever the device,
since the kernels have no backward.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
SM90A = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class CudaLibrary:
    """One `.cu` source -> one shared library, built and loaded lazily."""

    def __init__(self, name: str, source: Path, flags: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = source
        self.flags = tuple(flags)
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        """Where the build for the current source and flags lives."""
        tag = hashlib.sha256(self.source.read_bytes()
                             + " ".join(self.flags).encode()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}-{tag}.so"

    def build(self) -> Path:
        """Compile the library unless this source is built already; -> its
        path."""
        out = self.path()
        if out.exists():
            return out
        from torch.utils.cpp_extension import CUDA_HOME
        nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME else "nvcc"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}."
                            f"{threading.get_ident()}.tmp")
        proc = subprocess.run([nvcc, *self.flags, "-o", str(tmp),
                               str(self.source)], capture_output=True,
                              text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{self.source}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
        return self._lib

    def launch(self, entry: str, device, *args) -> None:
        """Call the C entry `entry` with `args` and the handle of PyTorch's
        current stream on `device`, inside that device; raise on a nonzero
        return: a negative one is the CUDA driver's `CUresult` (a tensor map
        it refused), a positive one a `cudaError`."""
        fn = getattr(self.load(), entry)
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc < 0:
            raise RuntimeError(f"{self.name} ({entry}): the CUDA driver "
                               f"refused a tensor map: CUresult {-rc}")
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed ({entry}): "
                               f"cudaError {rc}")


def build_all(libraries: Sequence[CudaLibrary]) -> list:
    """Run one `nvcc` per library, all at once; -> their paths in order."""
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        return list(pool.map(CudaLibrary.build, libraries))


_COUNT_LOCK = threading.Lock()


class Launches(dict):
    """A wrapper's launch counts by key, from 0 at import; `add` and
    `reset` take one lock shared by every wrapper, so the counts stay exact
    under threads (a DSE service scores several jobs at once)."""

    def __init__(self, *keys: str):
        super().__init__((k, 0) for k in keys)

    def add(self, *keys: str) -> None:
        """Count one launch under each of `keys`."""
        with _COUNT_LOCK:
            for k in keys:
                self[k] += 1

    def reset(self) -> None:
        with _COUNT_LOCK:
            for k in self:
                self[k] = 0


def aligned(t, nbytes: int = 16, dims: Optional[Sequence[int]] = None,
            offset: int = 0) -> bool:
    """Whether `t`'s base pointer plus `offset` bytes is a multiple of
    `nbytes`, and so is the stride in bytes, positive, of each dim of
    `dims` (default: all but the last) longer than 1.  Pure Python, no
    launch."""
    if (t.data_ptr() + offset) % nbytes:
        return False
    size, shape, stride = t.element_size(), t.shape, t.stride()
    for d in range(len(shape) - 1) if dims is None else dims:
        if shape[d] > 1 and (stride[d] <= 0 or stride[d] * size % nbytes):
            return False
    return True


def fitting(t):
    """`t` itself where `aligned`, else a fresh contiguous copy (the
    allocator's blocks start 512-byte aligned)."""
    if aligned(t):
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def needs_grad(*tensors) -> bool:
    """Whether autograd records a gradient through any of `tensors`."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def cuda_only(what: str, device) -> None:
    """Raise unless `device` is a CUDA device: `what` runs nowhere else."""
    if device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {device}")


def forward_only(what: str, *tensors) -> None:
    """Raise when autograd would need a gradient through `what`, a kernel
    with no backward, from any of `tensors`."""
    if needs_grad(*tensors):
        raise RuntimeError(f"the {what} kernel has no backward; call it "
                           f"under torch.no_grad()")
