"""Plain float32 reference of IBM's Granite 4.0-H language models
(`granitemoehybrid`; the released config.json of granite-4.0-h-small):
token embedding times `embedding_multiplier`; per layer a pre-norm mixer,
Mamba-2 or attention by `layer_types`, and a pre-norm mixture of experts,
each branch added to the residual times `residual_multiplier`; a final
RMS norm; the tied head at the last position, divided by
`logits_scaling`.

- The Mamba-2 mixer is `reference/mamba2.py`'s, written out again here
  (a reference imports only `plain.py`): in_proj to z, x, B, C, dt; the
  causal depthwise conv with bias and SiLU; dt = softplus(dt + dt_bias),
  A = -exp(A_log); the SSD scan (`plain.ssd`); the D skip; the gated RMS
  norm norm(y * silu(z)) over all of d_inner (one group); out_proj.
- Attention is grouped-query with no positional embedding
  (`position_embedding_type` "nope") and the softmax scale
  `attention_multiplier`, not head_dim^-0.5; no biases.
- The MoE routes each token to the `top_k` largest of the router's
  logits, its gates the softmax over those k logits; each routed expert
  is a SwiGLU of width `d_expert` run on the tokens routed to it (a loop
  over experts), its rows weighted by their gates and summed; a shared
  SwiGLU expert of width `d_shared` runs on every token and is added.

Departures from the release, each as the benchmark runs it:
- the whole residual stream and every product are float32 (the release
  computes in bf16);
- the SSD scan uses the configuration's chunk (128, not 256), which
  changes no value;
- no dropout, no router auxiliary loss, no cache: a forward pass only.

Parameters use the program's names (`PARAMS`).  Initial values: every
matrix normal with std 0.02 (initializer_range, which the catalog's row
omits: assumed); the conv, A_log, dt_bias and D drawn as
`reference/mamba2.py` draws them; norm scales 1 plus normal noise of std
0.1, so that a norm that drops its weight shows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.plain import Products, rms_norm, ssd

STD = 0.02
NORM_JITTER = 0.1


def PARAMS(m: dict) -> dict:
    """-> {parameter name: (shape, init)} at the configuration `m`."""
    d, v, k = m["d_model"], m["vocab"], m["d_conv"]
    h, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    e, f, fs = m["n_experts"], m["d_expert"], m["d_shared"]
    di = m["expand"] * d
    gn = m["ssm_ngroups"] * m["d_state"]
    nh = di // m["ssm_headdim"]
    conv_std = 1.0 / math.sqrt(3 * k)
    norm = ("one_plus_normal", NORM_JITTER)
    mat = ("normal", STD)
    out = {"embed": ((v, d), mat), "ln_f.scale": ((d,), norm)}
    for i, kind in enumerate(m["layer_types"]):
        p = f"layers.{i}."
        out[p + "ln1.scale"] = ((d,), norm)
        if kind == "mamba":
            out[p + "ssm.in_proj"] = ((d, 2 * di + 2 * gn + nh), mat)
            out[p + "ssm.conv_w"] = ((k, di + 2 * gn), ("normal", conv_std))
            out[p + "ssm.conv_b"] = ((di + 2 * gn,), ("normal", conv_std))
            out[p + "ssm.A_log"] = ((nh,), ("log_uniform", 1.0, 16.0))
            out[p + "ssm.dt_bias"] = ((nh,), ("softplus_inv_log_uniform",
                                              1e-3, 1e-1))
            out[p + "ssm.D"] = ((nh,), ("const", 1.0))
            out[p + "ssm.out_norm"] = ((di,), norm)
            out[p + "ssm.out_proj"] = ((di, d), mat)
        else:
            out[p + "attn.wq"] = ((d, h, hd), mat)
            out[p + "attn.wk"] = ((d, hkv, hd), mat)
            out[p + "attn.wv"] = ((d, hkv, hd), mat)
            out[p + "attn.wo"] = ((h, hd, d), mat)
        out[p + "ln2.scale"] = ((d,), norm)
        out[p + "mlp.router"] = ((d, e), mat)
        out[p + "mlp.w_gate"] = ((e, d, f), mat)
        out[p + "mlp.w_up"] = ((e, d, f), mat)
        out[p + "mlp.w_down"] = ((e, f, d), mat)
        out[p + "mlp.shared.w_gate"] = ((d, fs), mat)
        out[p + "mlp.shared.w_up"] = ((d, fs), mat)
        out[p + "mlp.shared.w_down"] = ((fs, d), mat)
    return out


def _causal_conv(u, w, bias):
    """Depthwise causal convolution: y[t] = sum_j w[j] u[t - (K-1) + j]
    + bias, zeros before the first position.  u [B, T, C], w [K, C]."""
    k, t = w.shape[0], u.shape[1]
    full = F.pad(u, (0, 0, k - 1, 0))
    return sum(full[:, j:j + t] * w[j].float() for j in range(k)) \
        + bias.float()


def mamba_mixer(w: dict, p: str, m: dict, x, mm: Products):
    """One Mamba-2 mixer on x [B, T, d] (float32) -> [B, T, d]."""
    b, t, _ = x.shape
    di = m["expand"] * m["d_model"]
    g, n, hp = m["ssm_ngroups"], m["d_state"], m["ssm_headdim"]
    gn, nh = g * n, di // hp
    z, xbc, dtr = torch.split(mm(x, w[p + "in_proj"]),
                              [di, di + 2 * gn, nh], dim=-1)
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


def route(logits, k: int):
    """-> (gates [T, k], expert ids [T, k]): the k largest logits of each
    row and the softmax over them."""
    top, idx = logits.topk(k, dim=-1)
    return torch.softmax(top, dim=-1), idx


def _swiglu(x, w_gate, w_up, w_down, mm: Products):
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def moe(w: dict, p: str, m: dict, x, mm: Products):
    """The mixture of experts and its shared expert on x [B, S, d]
    (float32) -> [B, S, d]."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, idx = route(mm(xt, w[p + "router"]), m["top_k"])
    out = _swiglu(xt, w[p + "shared.w_gate"], w[p + "shared.w_up"],
                  w[p + "shared.w_down"], mm)
    for e in range(m["n_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y = _swiglu(xt[tok], w[p + "w_gate"][e], w[p + "w_up"][e],
                        w[p + "w_down"][e], mm)
            out.index_add_(0, tok, y * gates[tok, slot, None])
    return out.reshape(b, s, d)


def causal_attention(q, k, v, scale: float):
    """softmax(scale q k^T, causal) v for q [B, S, H, D] and k, v [B, S,
    Hkv, D] (query head h reads KV head h // (H / Hkv)), as
    `plain.causal_attention` with the scale given.  One batch row at a
    time, all heads at once, float32."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for i in range(b):
        qi = q[i].transpose(0, 1)                               # [H, S, D]
        ki = k[i].transpose(0, 1).repeat_interleave(group, 0)
        vi = v[i].transpose(0, 1).repeat_interleave(group, 0)
        scores = (qi @ ki.transpose(1, 2)) * scale
        scores = scores.masked_fill(~mask, float("-inf"))
        out[i] = (torch.softmax(scores, dim=-1) @ vi).transpose(0, 1)
    return out


def attention(w: dict, p: str, m: dict, x, mm: Products):
    """Causal grouped-query attention with no positions, softmax scale
    `attention_multiplier`, on x [B, S, d] (float32) -> [B, S, d]."""
    b, s, d = x.shape
    h, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = mm(x, w[p + "wq"].reshape(d, h * hd)).view(b, s, h, hd)
    k = mm(x, w[p + "wk"].reshape(d, hkv * hd)).view(b, s, hkv, hd)
    v = mm(x, w[p + "wv"].reshape(d, hkv * hd)).view(b, s, hkv, hd)
    o = causal_attention(q, k, v, m["attention_multiplier"])
    return mm(o.reshape(b, s, h * hd), w[p + "wo"].reshape(h * hd, d))


def forward_last(w: dict, m: dict, tokens: torch.Tensor,
                 mm: Products) -> torch.Tensor:
    """Logits [B, V] (float32) at the last position of `tokens` [B, S],
    from the weights `w` (by `PARAMS` name, any float type)."""
    eps, r = m["norm_eps"], m["residual_multiplier"]
    x = w["embed"][tokens].float() * m["embedding_multiplier"]
    for i, kind in enumerate(m["layer_types"]):
        p = f"layers.{i}."
        h = rms_norm(x, w[p + "ln1.scale"], eps)
        if kind == "mamba":
            x = x + r * mamba_mixer(w, p + "ssm.", m, h, mm)
        else:
            x = x + r * attention(w, p + "attn.", m, h, mm)
        x = x + r * moe(w, p + "mlp.", m, rms_norm(x, w[p + "ln2.scale"],
                                                   eps), mm)
    last = rms_norm(x[:, -1], w["ln_f.scale"], eps)
    return mm(last, w["embed"].T) / m["logits_scaling"]
