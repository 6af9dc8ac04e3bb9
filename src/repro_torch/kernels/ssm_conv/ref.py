"""Plain PyTorch version of Mamba2's causal conv chain: the eager chain of
the JAX package's `models/ssm.py::mamba2_forward` from in_proj's output to
the SSD scan's inputs (split, concat of x, B and C, causal depthwise conv
with bias and SiLU, cast to float32, dt's softplus).  It lives here, not in
`models/ssm.py` (which imports it, and whose decode shares `split_proj`,
`causal_conv` and `dt_softplus`), so that the model can call
`ops.ssm_conv` without an import cycle.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def split_proj(zxbcdt, d_inner: int, gn: int):
    """zxbcdt [..., 2 d_inner + 2 gn + H] -> views (z, x, B, C, dtr)."""
    return torch.split(zxbcdt, [d_inner, d_inner, gn, gn, zxbcdt.shape[-1]
                                - 2 * d_inner - 2 * gn], dim=-1)


def causal_conv(xbc, w, b, state=None):
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


def dt_softplus(dtr, dt_bias):
    """dt = softplus(dtr + dt_bias) in float32."""
    return F.softplus(dtr.float() + dt_bias.float())


def conv_chain(zxbcdt, conv_w, conv_b, dt_bias, d_inner: int, gn: int):
    """zxbcdt [B, T, 2 d_inner + 2 gn + H] -> (z [B, T, d_inner], a view of
    zxbcdt; conv32 [B, T, d_inner + 2 gn], the SiLU of the causal conv of
    x, B and C in float32; dt [B, T, H] float32).  The conv runs in
    zxbcdt's type and its state, a view of its padded input, is dropped at
    once."""
    z, xc, B, C, dtr = split_proj(zxbcdt, d_inner, gn)
    conv_in = torch.cat([xc, B, C], dim=-1)
    conv32 = causal_conv(conv_in, conv_w, conv_b)[0].float()
    return z, conv32, dt_softplus(dtr, dt_bias)
