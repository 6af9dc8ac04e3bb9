"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060].

The port of the JAX package's `models/ssm.py`.  Prefill runs the chunked
SSD scan through `kernels/ssd_scan/ops.py::ssd_scan` (its plain version
`ssd_chunk_scan_streaming` for CPU tensors, the CUDA kernel for CUDA
tensors); training runs the model's own differentiable scan,
`ssd_chunk_scan_streaming`, as the reference's model does in every mode
(the kernel has no backward); decode is the O(1) recurrent state update.
The plain SSD functions live in `kernels/ssd_scan/ref.py` and are
re-exported here.

Layout: x [B, T, D] -> in_proj -> (z, xc, B, C, dt); causal depthwise conv
on (xc, B, C); SSD over heads H = d_inner / headdim with scalar A per head;
gated (silu(z)) output projection.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.ssd_scan import ops as ssd_ops
from ..kernels.ssd_scan.ref import (segsum, ssd_chunk_scan,  # noqa: F401
                                    ssd_chunk_scan_streaming, ssd_reference)
from .layers import ParamInit, fold_tokens, rms_norm, shard, split_dim


class Mamba2(nn.Module):
    """`in_proj` [d, 2*di + 2*G*N + H], `conv_w` [K, conv_dim], `conv_b`,
    `A_log` [H], `dt_bias` [H], `D` [H], `out_norm` [di], `out_proj`
    [di, d], named as the reference's params."""

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        g, n = cfg.ssm_ngroups, cfg.d_state
        nh = cfg.n_ssm_heads
        conv_dim = di + 2 * g * n
        self.in_proj = init.dense(d, 2 * di + 2 * g * n + nh,
                                  axes=("embed", "ssm_inner"))
        self.conv_w = init.dense(cfg.d_conv, conv_dim,
                                 axes=(None, "ssm_inner"),
                                 scale=cfg.d_conv ** -0.5)
        self.conv_b = init.zeros(conv_dim, axes=("ssm_inner",))
        self.A_log = init.const(torch.log(torch.linspace(1.0, 16.0, nh)),
                                axes=("ssm_heads",))
        self.dt_bias = init.zeros(nh, axes=("ssm_heads",))
        self.D = init.ones(nh, axes=("ssm_heads",))
        self.out_norm = init.ones(di, axes=("ssm_inner",))
        self.out_proj = init.dense(di, d, axes=("ssm_inner", "embed"))


def init_mamba2(init: ParamInit, cfg: ModelConfig) -> Mamba2:
    return Mamba2(init, cfg)


def _split_proj(cfg: ModelConfig, zxbcdt):
    di = cfg.d_inner
    gn = cfg.ssm_ngroups * cfg.d_state
    return torch.split(zxbcdt, [di, di, gn, gn, zxbcdt.shape[-1] - 2 * di
                                - 2 * gn], dim=-1)


def _causal_conv(xbc, w, b, state=None):
    """Depthwise causal conv1d.  xbc: [B,T,C]; w: [K,C].  Returns (silu(y),
    the last K-1 inputs [B,K-1,C]); `state` is the history before xbc
    (zeros when None)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                            dtype=xbc.dtype, device=xbc.device)
    full = torch.cat([state, xbc], dim=1)                  # [B, T+K-1, C]
    # windowed sum: y[t] = sum_j w[j] * full[t+j]
    t = xbc.shape[1]
    y = sum(full[:, j:j + t, :] * w[j] for j in range(k))
    y = y + b
    new_state = full[:, -(k - 1):, :] if k > 1 else state
    return F.silu(y), new_state


def _dt_and_a(p: Mamba2, dtr):
    dt = F.softplus(dtr.float() + p.dt_bias.float())
    return dt, -torch.exp(p.A_log.float())


def mamba2_forward(p: Mamba2, cfg: ModelConfig, x):
    """x: [B,T,D] -> [B,T,D].  The SSD scan runs on float32 views of the
    conv output (xh, B and C are strided slices of one float32 tensor):
    while gradients are recorded for any of its inputs, on the
    differentiable `ssd_chunk_scan_streaming` (the reference's scan, in
    every mode there); otherwise on `ssd_ops.ssd_scan` (the CUDA kernel
    for CUDA tensors, which raises under autograd).  The choice is by
    grad mode only, never by a failure."""
    zxbcdt = shard(fold_tokens(x, p.in_proj) @ p.in_proj,
                   "batch", None, "ssm_inner")
    z, xc, B, C, dtr = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xc, B, C], dim=-1)
    conv_out, _ = _causal_conv(conv_in, p.conv_w, p.conv_b)
    di = cfg.d_inner
    g, n = cfg.ssm_ngroups, cfg.d_state
    b, t, _ = x.shape
    h, pdim = cfg.n_ssm_heads, cfg.ssm_headdim
    conv32 = conv_out.float()
    xh = shard(split_dim(conv32[..., :di], -1, (h, pdim)),
               "batch", None, "ssm_heads", None)
    Bh = split_dim(conv32[..., di:di + g * n], -1, (g, n))
    Ch = split_dim(conv32[..., di + g * n:], -1, (g, n))
    dt, A = _dt_and_a(p, dtr)
    scan_args = (xh, dt, A, Bh, Ch)
    if torch.is_grad_enabled() and any(v.requires_grad for v in scan_args):
        y = ssd_chunk_scan_streaming(*scan_args, cfg.chunk)
    else:
        y = ssd_ops.ssd_scan(*scan_args, chunk=cfg.chunk)
    y = shard(y + xh * p.D.float()[None, None, :, None],
              "batch", None, "ssm_heads", None)
    y = y.reshape(b, t, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.out_norm, cfg.norm_eps)
    return shard(fold_tokens(y, p.out_proj) @ p.out_proj,
                 "batch", "seq", "embed")


def mamba2_init_state(cfg: ModelConfig, batch: int, dtype,
                      device=None) -> Dict[str, torch.Tensor]:
    g, n = cfg.ssm_ngroups, cfg.d_state
    conv_dim = cfg.d_inner + 2 * g * n
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.n_ssm_heads, n, cfg.ssm_headdim),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(p: Mamba2, cfg: ModelConfig, x, state):
    """Single-step recurrence.  x: [B,1,D]; state {"conv" [B,K-1,C],
    "ssm" [B,H,N,P]}.

    Unlike the reference, which returns new state arrays, the new conv and
    ssm states are written into `state` in place, and the same dict comes
    back (the values equal the reference's)."""
    zxbcdt = x @ p.in_proj
    z, xc, B, C, dtr = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xc, B, C], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, p.conv_w, p.conv_b,
                                        state["conv"])
    di = cfg.d_inner
    g, n = cfg.ssm_ngroups, cfg.d_state
    b = x.shape[0]
    h, pdim = cfg.n_ssm_heads, cfg.ssm_headdim
    conv32 = conv_out.float()
    xh = split_dim(conv32[:, 0, :di], -1, (h, pdim))
    Bh = split_dim(conv32[:, 0, di:di + g * n], -1, (g, n)) \
        .repeat_interleave(h // g, dim=1)                  # [B,H,N]
    Ch = split_dim(conv32[:, 0, di + g * n:], -1, (g, n)) \
        .repeat_interleave(h // g, dim=1)
    dt, A = _dt_and_a(p, dtr)
    dt = dt[:, 0]                                          # [B,H]
    decay = torch.exp(dt * A[None, :])
    s = state["ssm"] * decay[..., None, None] + torch.einsum(
        "bhn,bh,bhp->bhnp", Bh, dt, xh)
    y = torch.einsum("bhn,bhnp->bhp", Ch, s)
    y = y + xh * p.D.float()[None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.out_norm, cfg.norm_eps)
    state["conv"].copy_(conv_state)
    state["ssm"].copy_(s)
    return y @ p.out_proj, state
