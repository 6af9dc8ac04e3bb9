"""Plain PyTorch version of the RMS norm: the eager float32 chain of the
JAX package's `models/layers.py::rms_norm`, which `models/layers.py` ran
inline before the op.  Differentiable; nothing here imports the model."""
from __future__ import annotations

import torch


def rms_norm(x, weight, eps: float):
    """x [..., d], weight [d] -> x / rms(x) * weight over the last dim, in
    float32, cast back to x's type."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dtype)
