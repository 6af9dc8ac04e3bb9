"""Plain float32 reference of a Mamba-2 language model [arXiv:2405.21060]:
token embedding; per layer a pre-norm Mamba-2 mixer added to the residual;
a final RMS norm; the tied head at the last position.

The mixer, as the paper's Mamba-2 block (and `mamba_ssm`'s `Mamba2`):
in_proj to (z, x, B, C, dt); a depthwise causal convolution of width
`d_conv` with bias over (x, B, C), then SiLU; dt = softplus(dt + dt_bias),
A = -exp(A_log); the SSD scan (`plain.ssd`); the D skip y + D x; the gated
RMS norm norm(y * silu(z)) * out_norm over all of d_inner (one group);
out_proj.

Departures from the published description:
- the whole residual stream and every product are float32 (the released
  model keeps its residual in float32 too, its products in the weights'
  type);
- the scan uses the configuration's chunk, which changes no value.

Parameters use the program's names (`PARAMS`).  Initial values follow
`mamba_ssm`'s initialisation of the released model: in_proj and the
depthwise conv as PyTorch's default (std 1/sqrt(3 fan_in)), out_proj the
same divided by sqrt(n_layers) (`rescale_prenorm_residual`), the embedding
std 0.02, A = U[1, 16], dt = exp(U[log 1e-3, log 1e-1]) stored as its
inverse softplus in dt_bias, D = 1; norm scales are 1 plus normal noise of
std 0.1, so that a norm that drops its weight shows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.plain import Products, rms_norm, ssd

NORM_JITTER = 0.1


def _sizes(m: dict):
    di = m["expand"] * m["d_model"]
    gn = m["ssm_ngroups"] * m["d_state"]
    nh = di // m["ssm_headdim"]
    return di, gn, nh


def PARAMS(m: dict) -> dict:
    """-> {parameter name: (shape, init)} at the configuration `m`."""
    d, v, k = m["d_model"], m["vocab"], m["d_conv"]
    di, gn, nh = _sizes(m)
    conv_dim = di + 2 * gn
    conv_std = 1.0 / math.sqrt(3 * k)
    norm = ("one_plus_normal", NORM_JITTER)
    out = {"embed": ((v, d), ("normal", 0.02)),
           "ln_f.scale": ((d,), norm)}
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        out[p + "ln1.scale"] = ((d,), norm)
        out[p + "ssm.in_proj"] = ((d, 2 * di + 2 * gn + nh),
                                  ("normal", 1.0 / math.sqrt(3 * d)))
        out[p + "ssm.conv_w"] = ((k, conv_dim), ("normal", conv_std))
        out[p + "ssm.conv_b"] = ((conv_dim,), ("normal", conv_std))
        out[p + "ssm.A_log"] = ((nh,), ("log_uniform", 1.0, 16.0))
        out[p + "ssm.dt_bias"] = ((nh,), ("softplus_inv_log_uniform",
                                          1e-3, 1e-1))
        out[p + "ssm.D"] = ((nh,), ("const", 1.0))
        out[p + "ssm.out_norm"] = ((di,), norm)
        out[p + "ssm.out_proj"] = ((di, d), (
            "normal", 1.0 / math.sqrt(3 * di) / math.sqrt(m["n_layers"])))
    return out


def _causal_conv(u, w, bias):
    """Depthwise causal convolution: y[t] = sum_j w[j] u[t - (K-1) + j]
    + bias, zeros before the first position.  u [B, T, C], w [K, C]."""
    k, t = w.shape[0], u.shape[1]
    full = F.pad(u, (0, 0, k - 1, 0))
    return sum(full[:, j:j + t] * w[j].float() for j in range(k)) \
        + bias.float()


def mixer(w: dict, p: str, m: dict, x, mm: Products):
    """One Mamba-2 mixer on x [B, T, d] (float32) -> [B, T, d]."""
    b, t, _ = x.shape
    di, gn, nh = _sizes(m)
    g, n, hp = m["ssm_ngroups"], m["d_state"], m["ssm_headdim"]
    zxbcdt = mm(x, w[p + "in_proj"])
    z, xbc, dtr = torch.split(zxbcdt, [di, di + 2 * gn, nh], dim=-1)
    xbc = F.silu(_causal_conv(xbc, w[p + "conv_w"], w[p + "conv_b"]))
    xs, bm, cm = torch.split(xbc, [di, gn, gn], dim=-1)
    dt = F.softplus(dtr + w[p + "dt_bias"].float())
    a = -torch.exp(w[p + "A_log"].float())
    xh = xs.reshape(b, t, nh, hp)
    y = ssd(xh, dt, a, bm.reshape(b, t, g, n), cm.reshape(b, t, g, n),
            m["chunk"])
    y = (y + xh * w[p + "D"].float()[:, None]).reshape(b, t, di)
    y = rms_norm(y * F.silu(z), w[p + "out_norm"], m["norm_eps"])
    return mm(y, w[p + "out_proj"])


def forward_last(w: dict, m: dict, tokens: torch.Tensor,
                 mm: Products) -> torch.Tensor:
    """Logits [B, V] (float32) at the last position of `tokens` [B, T]."""
    eps = m["norm_eps"]
    x = w["embed"][tokens].float()
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        x = x + mixer(w, p + "ssm.", m,
                      rms_norm(x, w[p + "ln1.scale"], eps), mm)
    last = rms_norm(x[:, -1], w["ln_f.scale"], eps)
    return mm(last, w["embed"].T)
