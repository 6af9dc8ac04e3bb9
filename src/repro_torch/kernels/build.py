"""Build and load the port's CUDA kernels.

Each kernel source is one `.cu` file with a plain C interface.  `nvcc`
compiles it for sm_90a into a shared library under
`build/repro_torch_kernels/` at the repository root (git-ignored), at first
use and never at import; the file name carries a hash of the source and
the flags, so an edit rebuilds.  The compiler's register/spill report
(`-Xptxas -v`) is kept beside it as `.log`.  The library is loaded with
`ctypes` and bound once by the kernel module's `bind` callback.
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


def build_all(libraries: Sequence[CudaLibrary]) -> list:
    """Run one `nvcc` per library, all at once; -> their paths in order."""
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        return list(pool.map(CudaLibrary.build, libraries))
