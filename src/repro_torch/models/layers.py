"""Shared model layers: norms, activations, RoPE/M-RoPE, init helpers.

The port of the JAX package's `models/layers.py`.  Norms and RoPE compute
in float32 and cast back to the input's type, as there.  Parameters are
`nn.Parameter`s of small `nn.Module`s; the init helpers draw from an
explicit `torch.Generator` (`ParamInit`).  The sharding hooks (`shard`,
`set_shard_fn`, `set_embed_lookup`) belong to the parallel slice and are
not ported yet.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    return _DTYPES[name]


# --------------------------------------------------------------------------
# Parameter creation
# --------------------------------------------------------------------------
class ParamInit:
    """Draws parameters from one `torch.Generator` (the counterpart of the
    JAX `ParamBuilder`): normal with std `fan_in ** -0.5` (or `scale`),
    drawn in float32 and cast to `dtype`, placed on `device`.  Values are
    drawn on the generator's device and moved, so a CPU generator seeds a
    model on the card."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = device

    def dense(self, *shape: int, scale: Optional[float] = None) -> nn.Parameter:
        fan_in = shape[0] if len(shape) > 1 else 1
        std = scale if scale is not None else fan_in ** -0.5
        v = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.generator.device) * std
        return nn.Parameter(v.to(self.device, self.dtype))

    def zeros(self, *shape: int) -> nn.Parameter:
        return nn.Parameter(torch.zeros(shape, dtype=self.dtype,
                                        device=self.device))

    def ones(self, *shape: int) -> nn.Parameter:
        return nn.Parameter(torch.ones(shape, dtype=self.dtype,
                                       device=self.device))

    def const(self, value) -> nn.Parameter:
        """A fixed value cast to `dtype` (the reference's `pb.const`)."""
        return nn.Parameter(torch.as_tensor(value).to(self.device,
                                                      self.dtype))


# --------------------------------------------------------------------------
def rms_norm(x, weight, eps=1e-5):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dtype)


def layer_norm(x, weight, bias, eps=1e-5):
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dtype)


class Norm(nn.Module):
    """`scale` (and `bias` for layernorm), named as the JAX params are."""

    def __init__(self, init: ParamInit, d: int, kind: str = "rmsnorm"):
        super().__init__()
        self.scale = init.ones(d)
        if kind == "layernorm":
            self.bias = init.zeros(d)


def norm(x, params: Norm, kind="rmsnorm", eps=1e-5):
    if kind == "rmsnorm":
        return rms_norm(x, params.scale, eps)
    return layer_norm(x, params.scale, params.bias, eps)


def activate(x_gate, x_up, act: str):
    """Gated/ungated MLP nonlinearity.  For non-GLU acts x_up is None."""
    if act == "swiglu":
        return F.silu(x_gate) * x_up
    if act == "gelu":
        return F.gelu(x_gate, approximate="tanh")
    if act == "relu2":                     # squared ReLU (Nemotron/Primer)
        r = F.relu(x_gate)
        return r * r
    raise ValueError(act)


# --------------------------------------------------------------------------
# RoPE / M-RoPE
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2,
                                      dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _inv_freqs(head_dim: int, theta: float, device: torch.device):
    """`rope_freqs` on `device`, copied there once: a copy from pageable
    host memory waits for the device's stream to drain, which per call
    would stall every layer."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def _rotate(x, ang):
    """x [..., S, H, D] rotated by angles [..., S, D/2], in float32."""
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta=10000.0):
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    inv = _inv_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * inv)


def apply_mrope(x, positions3, sections, theta=10000.0):
    """Qwen2-VL M-RoPE: positions3 [3, ..., S] (t, h, w) indices; the rotary
    half-dims are partitioned into `sections` (t, h, w) groups."""
    d = x.shape[-1]
    inv = _inv_freqs(d, theta, x.device)
    sec = np.cumsum((0,) + tuple(sections))
    assert sec[-1] == d // 2, (sections, d)
    ang = torch.cat([positions3[i][..., None].float() * inv[sec[i]:sec[i + 1]]
                     for i in range(3)], dim=-1)
    return _rotate(x, ang)


def sinusoidal_positions(seq: int, d: int):
    """Whisper-style fixed sinusoidal embeddings [S, D] (float32, host)."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / (10000 ** (dim / d))
    out = np.zeros((seq, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out)


def embedding_lookup(table, tokens):
    return F.embedding(tokens, table)
