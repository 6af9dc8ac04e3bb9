"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060].

The port of the JAX package's `models/ssm.py`.  Prefill and training run
three ops in turn: the conv chain between in_proj and the scan (split,
causal depthwise conv with bias and SiLU, float32 cast, dt's softplus),
`kernels/ssm_conv/ops.py::ssm_conv`; the chunked SSD scan,
`kernels/ssd_scan/ops.py::ssd_scan`; and the gate chain after it (the D
skip, cast, SiLU gate and RMS norm), `kernels/ssm_gate/ops.py::ssm_gate`.
Each op chooses for itself between its CUDA kernel and its plain,
differentiable version (`conv_chain`, `ssd_chunk_scan_streaming`,
`gate_chain`, in each package's `ref.py`), by one rule: the plain version
while autograd records a gradient through an input or for CPU and meta
tensors, the kernel for CUDA tensors (`kernels/build.py::needs_grad`).
Decode is the O(1) recurrent state update, with its own conv.  The plain
SSD functions are re-exported here.

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
from ..kernels.ssm_conv import ops as conv_ops
from ..kernels.ssm_conv.ref import causal_conv, dt_softplus, split_proj
from ..kernels.ssm_gate import ops as gate_ops
from ..obs.trace import NULL_TRACER
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


def mamba2_forward(p: Mamba2, cfg: ModelConfig, x, *, tracer=NULL_TRACER):
    """x: [B,T,D] -> [B,T,D].  The conv chain, the SSD scan and the gate
    chain run through `conv_ops.ssm_conv`, `ssd_ops.ssd_scan` and
    `gate_ops.ssm_gate`, each of which takes its plain, differentiable
    version while gradients are recorded (the module's rule).  The scan
    runs on float32 views of the conv output (xh, B and C are strided
    slices of one float32 tensor).  `tracer` records the spans "ssm.conv"
    (in_proj's output through dt's softplus), "ssm.scan" and "ssm.gate"
    (the D skip through the RMS norm)."""
    zxbcdt = shard(fold_tokens(x, p.in_proj) @ p.in_proj,
                   "batch", None, "ssm_inner")
    di = cfg.d_inner
    g, n = cfg.ssm_ngroups, cfg.d_state
    h, pdim = cfg.n_ssm_heads, cfg.ssm_headdim
    with tracer.span("ssm.conv"):
        z, conv32, dt = conv_ops.ssm_conv(zxbcdt, p.conv_w, p.conv_b,
                                          p.dt_bias, d_inner=di, gn=g * n)
        xh = shard(split_dim(conv32[..., :di], -1, (h, pdim)),
                   "batch", None, "ssm_heads", None)
        Bh = split_dim(conv32[..., di:di + g * n], -1, (g, n))
        Ch = split_dim(conv32[..., di + g * n:], -1, (g, n))
        A = -torch.exp(p.A_log.float())
    with tracer.span("ssm.scan"):
        y = ssd_ops.ssd_scan(xh, dt, A, Bh, Ch, chunk=cfg.chunk)
    with tracer.span("ssm.gate"):
        y = shard(y, "batch", None, "ssm_heads", None)
        y = gate_ops.ssm_gate(y, xh, p.D, z, p.out_norm, eps=cfg.norm_eps,
                              dtype=x.dtype)
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
    di = cfg.d_inner
    g, n = cfg.ssm_ngroups, cfg.d_state
    z, xc, B, C, dtr = split_proj(zxbcdt, di, g * n)
    conv_in = torch.cat([xc, B, C], dim=-1)
    conv_out, conv_state = causal_conv(conv_in, p.conv_w, p.conv_b,
                                       state["conv"])
    b = x.shape[0]
    h, pdim = cfg.n_ssm_heads, cfg.ssm_headdim
    conv32 = conv_out.float()
    xh = split_dim(conv32[:, 0, :di], -1, (h, pdim))
    Bh = split_dim(conv32[:, 0, di:di + g * n], -1, (g, n)) \
        .repeat_interleave(h // g, dim=1)                  # [B,H,N]
    Ch = split_dim(conv32[:, 0, di + g * n:], -1, (g, n)) \
        .repeat_interleave(h // g, dim=1)
    dt = dt_softplus(dtr, p.dt_bias)[:, 0]                 # [B,H]
    A = -torch.exp(p.A_log.float())
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
