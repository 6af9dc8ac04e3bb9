"""Plain PyTorch version of Mamba2's gate chain: the eager lines of the
JAX package's `models/ssm.py::mamba2_forward` from the SSD scan's output
to out_proj's input (the D skip in float32, the cast to the compute type,
the SiLU gate and the RMS norm).  The model annotates the sharding of its
inputs; nothing here imports the model.
"""
from __future__ import annotations

import torch.nn.functional as F

from ..rms_norm.ref import rms_norm


def gate_chain(y, xh, D, z, out_norm, eps: float, dtype):
    """y, xh float32 [B, T, H, P] (the scan's output and input), D [H], z
    [B, T, H P], out_norm [H P] -> rms_norm((y + xh D) in `dtype` *
    silu(z), out_norm, eps) [B, T, H P]."""
    b, t, h, p = y.shape
    y = y + xh * D.float()[None, None, :, None]
    y = y.reshape(b, t, h * p).to(dtype)
    return rms_norm(y * F.silu(z), out_norm, eps)
