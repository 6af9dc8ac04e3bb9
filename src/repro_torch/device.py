"""Explicit device resolution for the port's entry points.

Every public entry point takes `device=` and defaults to "cuda".  A run
never moves to the host on its own: asking for the card on a host that
has none raises here, and only `device="cpu"` runs on the CPU."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def as_device(device="cuda") -> torch.device:
    """-> torch.device; raises when a CUDA device is asked for and the
    host has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; "
            f"pass device='cpu' to run on the host")
    return dev


def to_device(a, device: torch.device) -> torch.Tensor:
    """One host numpy array -> one tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def on_device(dev: torch.device):
    """Context that makes `dev` the calling thread's current CUDA device
    (a no-op for the CPU).  A new thread starts on device 0 whatever its
    creator's current device was."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())
