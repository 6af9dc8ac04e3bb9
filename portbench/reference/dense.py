"""Plain float32 reference of a decoder-only transformer with grouped-query
attention (phi-3-mini [arXiv:2404.14219] and the Llama-2 block structure it
follows): token embedding; per layer a pre-norm causal self-attention with
rotary positions and a pre-norm MLP, each added to the residual; a final
RMS norm; the head at the last position.

Departures from the published description, each as the benchmark runs it:
- the head is the embedding's transpose when `tie_embeddings`, its own
  `lm_head` otherwise (phi-3-mini's release: untied);
- attention is causal within the configuration's `sliding_window` (the
  released phi-3-mini-4k config's 2047; 0 for none), which the paper does
  not describe;
- rotary angles are computed in float64, then float32.

Parameters use the program's names (`PARAMS`), which is how the benchmark
hands the same tensors to both.  The initial values are the released
model's: every matrix normal with std 0.02 (`initializer_range`); norm
scales are 1 plus normal noise of std 0.1, so that a norm that drops its
weight shows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.plain import (Products, causal_attention, rms_norm,
                                       rope)

STD = 0.02
NORM_JITTER = 0.1


def PARAMS(m: dict) -> dict:
    """-> {parameter name: (shape, init)} at the configuration `m`."""
    d, hd, v = m["d_model"], m["head_dim"], m["vocab"]
    h, hkv, ff = m["n_heads"], m["n_kv_heads"], m["d_ff"]
    norm = ("one_plus_normal", NORM_JITTER)
    mat = ("normal", STD)
    out = {"embed": ((v, d), mat)}
    if not m["tie_embeddings"]:
        out["lm_head"] = ((d, v), mat)
    out["ln_f.scale"] = ((d,), norm)
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        out[p + "ln1.scale"] = ((d,), norm)
        out[p + "attn.wq"] = ((d, h, hd), mat)
        out[p + "attn.wk"] = ((d, hkv, hd), mat)
        out[p + "attn.wv"] = ((d, hkv, hd), mat)
        out[p + "attn.wo"] = ((h, hd, d), mat)
        out[p + "ln2.scale"] = ((d,), norm)
        out[p + "mlp.w_gate"] = ((d, ff), mat)
        if m["act"] == "swiglu":
            out[p + "mlp.w_up"] = ((d, ff), mat)
        out[p + "mlp.w_down"] = ((ff, d), mat)
    return out


def _mlp(w, p, m, h, mm):
    g = mm(h, w[p + "mlp.w_gate"])
    if m["act"] == "swiglu":
        a = F.silu(g) * mm(h, w[p + "mlp.w_up"])
    elif m["act"] == "gelu":
        a = F.gelu(g, approximate="tanh")
    elif m["act"] == "relu2":
        a = F.relu(g).square()
    else:
        raise ValueError(m["act"])
    return mm(a, w[p + "mlp.w_down"])


def forward_last(w: dict, m: dict, tokens: torch.Tensor,
                 mm: Products) -> torch.Tensor:
    """Logits [B, V] (float32) at the last position of `tokens` [B, S],
    from the weights `w` (by `PARAMS` name, any float type)."""
    b, s = tokens.shape
    d, hd, eps = m["d_model"], m["head_dim"], m["norm_eps"]
    h, hkv = m["n_heads"], m["n_kv_heads"]
    x = w["embed"][tokens].float()
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        a = rms_norm(x, w[p + "ln1.scale"], eps)
        q = mm(a, w[p + "attn.wq"].reshape(d, h * hd)).view(b, s, h, hd)
        k = mm(a, w[p + "attn.wk"].reshape(d, hkv * hd)).view(b, s, hkv, hd)
        v = mm(a, w[p + "attn.wv"].reshape(d, hkv * hd)).view(b, s, hkv, hd)
        q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
        o = causal_attention(q, k, v, m["sliding_window"]) \
            .reshape(b, s, h * hd)
        x = x + mm(o, w[p + "attn.wo"].reshape(h * hd, d))
        x = x + _mlp(w, p, m, rms_norm(x, w[p + "ln2.scale"], eps), mm)
    last = rms_norm(x[:, -1], w["ln_f.scale"], eps)
    head = w["embed"].T if m["tie_embeddings"] else w["lm_head"]
    return mm(last, head)
