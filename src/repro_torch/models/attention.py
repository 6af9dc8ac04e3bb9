"""Attention: GQA (grouped KV) for the full sequence and for decode.

The port of the JAX package's `models/attention.py`, GQA part.  Forward
paths:
  * train/prefill: full-sequence causal (or bidirectional / sliding-window)
    through `sdpa`, whose dispatch order is the reference's: the installed
    flash implementation (`set_flash_impl`; `kernels/flash_attention/ops.py`
    installs the CUDA kernel), then the blocked online-softmax path for long
    sequences, then the plain fp32-softmax path;
  * decode: a single new token against a KV cache.

MLA and cross-attention are not ported yet (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..configs.base import ModelConfig
from .layers import ParamInit, apply_mrope, apply_rope

# Hook: a fused flash-attention implementation for the full-sequence path
# (`repro_torch.kernels.flash_attention.ops.install`).
_FLASH_IMPL = None

# Blocked attention (online softmax over K/V blocks, no S x S matrix) above
# this many KV positions; 0 forces it everywhere (tests).
BLOCKED_ATTN_THRESHOLD = 4096
BLOCKED_ATTN_KBLOCK = 1024
NEG_INF = -1e30


def set_flash_impl(fn):
    global _FLASH_IMPL
    _FLASH_IMPL = fn


def set_blocked_threshold(n: int):
    global BLOCKED_ATTN_THRESHOLD
    BLOCKED_ATTN_THRESHOLD = n


def sdpa_blocked(q, k, v, *, causal=True, window=0, k_block: int = None):
    """Online-softmax attention over K/V blocks (the flash pattern as a
    Python loop over blocks).  q: [B,Sq,H,D] matched to k/v [B,Sk,Hkv,D] by
    GQA grouping.  fp32 accumulation."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    kb = min(k_block or BLOCKED_ATTN_KBLOCK, sk)
    assert sk % kb == 0, (sk, kb)
    group = h // hkv
    qf = q.reshape(b, sq, hkv, group, d).float()
    scale = d ** -0.5
    kr = k.reshape(b, sk // kb, kb, hkv, d).float()
    vr = v.reshape(b, sk // kb, kb, hkv, dv).float()
    qi = torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, group, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, group, sq), device=q.device)
    acc = torch.zeros((b, hkv, group, sq, dv), device=q.device)
    for blk in range(sk // kb):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kr[:, blk]) * scale
        kj = blk * kb + torch.arange(kb, device=q.device)
        ok = torch.ones((sq, kb), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kj[None, :] <= qi[:, None]
        if window:
            ok &= kj[None, :] > qi[:, None] - window
        s = s.masked_fill(~ok, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_cur[..., None])
        alpha = torch.exp(m - m_cur)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                    vr[:, blk])
        m = m_cur
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.movedim(3, 1).reshape(b, sq, h, dv)
    return out.to(q.dtype)


def _mask_bias(q_len, kv_len, causal, window, q_offset=0,
               dtype=torch.float32, device=None):
    if not causal and window == 0:
        return None
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    ok = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        ok &= kj <= qi
    if window:
        ok &= kj > qi - window
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def sdpa(q, k, v, *, causal=True, window=0, q_offset=0):
    """q/k: [B,S,H*,Dqk], v: [B,Sk,Hkv,Dv] -> [B,Sq,H,Dv].  fp32 softmax."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    dv = v.shape[-1]
    if _FLASH_IMPL is not None and causal and window == 0 \
            and sq == k.shape[1] and d == dv:
        return _FLASH_IMPL(q, k, v)
    if k.shape[1] >= BLOCKED_ATTN_THRESHOLD and q_offset == 0 \
            and sq == k.shape[1]:
        return sdpa_blocked(q, k, v, causal=causal, window=window)
    group = h // hkv
    qg = q.reshape(b, sq, hkv, group, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * (d ** -0.5)
    bias = _mask_bias(sq, k.shape[1], causal, window, q_offset,
                      device=q.device)
    if bias is not None:
        logits = logits + bias
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(b, sq, h, dv).to(q.dtype)


# --------------------------------------------------------------------------
# GQA
# --------------------------------------------------------------------------
class GQA(nn.Module):
    """`wq` [d, H, hd], `wk`/`wv` [d, Hkv, hd], `wo` [H, hd, d]."""

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        d, hd = cfg.d_model, cfg.d_head
        self.wq = init.dense(d, cfg.n_heads, hd)
        self.wk = init.dense(d, cfg.n_kv_heads, hd)
        self.wv = init.dense(d, cfg.n_kv_heads, hd)
        self.wo = init.dense(cfg.n_heads, hd, d)


def init_gqa(init: ParamInit, cfg: ModelConfig) -> GQA:
    return GQA(init, cfg)


def _rope_qk(cfg: ModelConfig, q, k, positions):
    if cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    return q, k


def gqa_forward(p: GQA, cfg: ModelConfig, x, positions, *, causal=True,
                window: int = 0):
    """Full-sequence attention.  x: [B,S,D]."""
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    q, k = _rope_qk(cfg, q, k, positions)
    out = sdpa(q, k, v, causal=causal, window=window)
    return torch.einsum("bshk,hkd->bsd", out, p.wo)


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_prefill_cache(p: GQA, cfg: ModelConfig, x, positions):
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if cfg.rope != "none":
        _, k = _rope_qk(cfg, k, k, positions)
    return {"k": k, "v": v}


def gqa_decode(p: GQA, cfg: ModelConfig, x, cache, pos: int, *,
               window: int = 0):
    """x: [B,1,D]; cache k/v: [B,S,Hkv,D]; pos: current length (int).

    Unlike the reference, which returns new cache arrays, the new key and
    value are written into `cache` in place, and the same dict comes back.
    The write lands where `lax.dynamic_update_slice` puts it: at `pos`,
    clamped to the last slot, so values agree with the reference for every
    `pos` (and for `pos < max_len` the write is exactly at `pos`)."""
    b = x.shape[0]
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k_new = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v_new = torch.einsum("bsd,dhk->bshk", x, p.wv)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new = _rope_qk(cfg, q, k_new, posv)
    k, v = cache["k"], cache["v"]
    s = k.shape[1]
    at = min(max(int(pos), 0), s - 1)
    k[:, at] = k_new[:, 0].to(k.dtype)
    v[:, at] = v_new[:, 0].to(v.dtype)
    kj = torch.arange(s, device=x.device)
    valid = kj <= pos
    if window:
        valid &= kj > pos - window
    hkv = k.shape[2]
    group = cfg.n_heads // hkv
    qg = q.reshape(b, 1, hkv, group, cfg.d_head)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * (cfg.d_head ** -0.5)
    logits = logits.masked_fill(~valid, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    out = out.reshape(b, 1, cfg.n_heads, cfg.d_head).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p.wo)
    return y, cache
