"""Attention: GQA (grouped KV), MLA (latent-compressed KV) and
cross-attention.

The port of the JAX package's `models/attention.py`.  Forward paths:
  * train/prefill: full-sequence causal (or bidirectional / sliding-window)
    through `sdpa`, whose dispatch order is the reference's: the installed
    flash implementation (`set_flash_impl`; `kernels/flash_attention/ops.py`
    installs the CUDA kernel), then the blocked online-softmax path for long
    sequences, then the plain fp32-softmax path;
  * decode: a single new token against a KV cache, written in place.

MLA's q/k head dim differs from its v head dim, and cross-attention has
`Sq != Sk`, so both take the plain path of `sdpa`, as in the reference.
MLA decode caches the compressed latent and the rope key only; the
weight-absorbed decode (`absorb=True`) folds W_UK into the query and W_UV
into the output projection.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from ..configs.base import ModelConfig
from ..obs.trace import NULL_TRACER
from ..parallel.local_shards import attention_on_local_shards
from .layers import (ParamInit, apply_mrope, apply_rope, fold_tokens,
                     merge_heads, project_heads, rms_norm, shard, split_dim)

# Hook: a fused flash-attention implementation for the full-sequence path
# (`repro_torch.kernels.flash_attention.ops.install`).
_FLASH_IMPL = None

# Blocked attention (online softmax over K/V blocks, no S x S matrix) above
# this many KV positions; 0 forces it everywhere (tests).
BLOCKED_ATTN_THRESHOLD = 4096
BLOCKED_ATTN_KBLOCK = 1024
NEG_INF = -1e30


def set_flash_impl(fn):
    """`fn(q, k, v, *, scale)` takes causal full attention from `sdpa`
    (`scale` None: D^-0.5); None removes it."""
    global _FLASH_IMPL
    _FLASH_IMPL = fn


def set_blocked_threshold(n: int):
    global BLOCKED_ATTN_THRESHOLD
    BLOCKED_ATTN_THRESHOLD = n


def sdpa_blocked(q, k, v, *, causal=True, window=0, k_block: int = None,
                 scale: float = None):
    """Online-softmax attention over K/V blocks (the flash pattern as a
    Python loop over blocks).  q: [B,Sq,H,D] matched to k/v [B,Sk,Hkv,D] by
    GQA grouping.  fp32 accumulation; softmax scale `scale` (None: D^-0.5)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    kb = min(k_block or BLOCKED_ATTN_KBLOCK, sk)
    assert sk % kb == 0, (sk, kb)
    group = h // hkv
    qf = split_dim(q, 2, (hkv, group)).float()
    scale = d ** -0.5 if scale is None else scale
    kr = split_dim(k, 1, (sk // kb, kb)).float()
    vr = split_dim(v, 1, (sk // kb, kb)).float()
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


def sdpa(q, k, v, *, causal=True, window=0, q_offset=0, scale=None):
    """q/k: [B,S,H*,Dqk], v: [B,Sk,Hkv,Dv] -> [B,Sq,H,Dv].  fp32 softmax of
    the logits times `scale` (None: Dqk^-0.5), on every path."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    dv = v.shape[-1]
    if _FLASH_IMPL is not None and causal and window == 0 \
            and sq == k.shape[1] and d == dv:
        return _FLASH_IMPL(q, k, v, scale=scale)
    if isinstance(q, DTensor):
        # per rank on local shards, differentiable
        return attention_on_local_shards(sdpa, q, k, v, causal=causal,
                                         window=window, q_offset=q_offset,
                                         scale=scale)
    if k.shape[1] >= BLOCKED_ATTN_THRESHOLD and q_offset == 0 \
            and sq == k.shape[1]:
        return sdpa_blocked(q, k, v, causal=causal, window=window,
                            scale=scale)
    group = h // hkv
    qg = split_dim(q, 2, (hkv, group))
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * (d ** -0.5 if scale is None else scale)
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
        self.wq = init.dense(d, cfg.n_heads, hd,
                             axes=("embed", "heads", "head_dim"))
        self.wk = init.dense(d, cfg.n_kv_heads, hd,
                             axes=("embed", "kv_heads", "head_dim"))
        self.wv = init.dense(d, cfg.n_kv_heads, hd,
                             axes=("embed", "kv_heads", "head_dim"))
        self.wo = init.dense(cfg.n_heads, hd, d,
                             axes=("heads", "head_dim", "embed"))


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
                window: int = 0, tracer=NULL_TRACER):
    """Full-sequence attention.  x: [B,S,D].  `tracer` records the spans
    "attn.rope" and "attn.core"."""
    q = shard(project_heads(x, p.wq),
              "batch", None, "heads", None)
    k = project_heads(x, p.wk)
    v = project_heads(x, p.wv)
    with tracer.span("attn.rope"):
        q, k = _rope_qk(cfg, q, k, positions)
    with tracer.span("attn.core"):
        out = sdpa(q, k, v, causal=causal, window=window,
                   scale=cfg.softmax_scale)
    return shard(merge_heads(out, p.wo),
                 "batch", "seq", "embed")


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_prefill_cache(p: GQA, cfg: ModelConfig, x, positions):
    k = project_heads(x, p.wk)
    v = project_heads(x, p.wv)
    if cfg.rope != "none":
        _, k = _rope_qk(cfg, k, k, positions)
    return {"k": k, "v": v}


def _slot(pos: int, s: int) -> int:
    """Where `lax.dynamic_update_slice` writes a decode step's entry in a
    cache of `s` positions: at `pos`, clamped to the cache."""
    return min(max(int(pos), 0), s - 1)


def write_slot(buf, at: int, val) -> None:
    """`buf[:, at] = val` in place (buf [B, S, ...], val [B, ...]).  A
    DTensor cache is written on its local shards: `val` is redistributed
    to the cache's placements (replicated over the mesh dims that shard
    S), and only the ranks whose S range holds `at` write."""
    if not isinstance(buf, DTensor):
        buf[:, at] = val.to(buf.dtype)
        return
    pl = []
    for p in buf.placements:
        if isinstance(p, Shard) and p.dim == 1:
            pl.append(Replicate())
        elif isinstance(p, Shard) and p.dim > 1:
            pl.append(Shard(p.dim - 1))
        else:
            pl.append(p)
    if not isinstance(val, DTensor):
        val = DTensor.from_local(val, buf.device_mesh,
                                 [Replicate()] * buf.device_mesh.ndim,
                                 run_check=False)
    local_val = val.to(buf.dtype).redistribute(buf.device_mesh,
                                              pl).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        buf.shape, buf.device_mesh, buf.placements)
    if offset[1] <= at < offset[1] + shape[1]:
        buf.to_local()[:, at - offset[1]] = local_val


def gqa_decode(p: GQA, cfg: ModelConfig, x, cache, pos: int, *,
               window: int = 0):
    """x: [B,1,D]; cache k/v: [B,S,Hkv,D]; pos: current length (int).

    Unlike the reference, which returns new cache arrays, the new key and
    value are written into `cache` in place, and the same dict comes back.
    The write lands where `lax.dynamic_update_slice` puts it: at `pos`,
    clamped to the last slot, so values agree with the reference for every
    `pos` (and for `pos < max_len` the write is exactly at `pos`)."""
    b = x.shape[0]
    q = project_heads(x, p.wq)
    k_new = project_heads(x, p.wk)
    v_new = project_heads(x, p.wv)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.rope == "mrope":
        # (pos, pos, pos) for every row: what the reference computes from
        # `posv` [B, 1] indexed as positions3 (JAX clamps the index at B<3)
        posv = posv.expand(3, b, 1)
    q, k_new = _rope_qk(cfg, q, k_new, posv)
    k, v = cache["k"], cache["v"]
    s = k.shape[1]
    at = _slot(pos, s)
    write_slot(k, at, k_new[:, 0])
    write_slot(v, at, v_new[:, 0])
    k = shard(k, "batch", "kv_seq", "kv_heads", None)
    v = shard(v, "batch", "kv_seq", "kv_heads", None)
    kj = torch.arange(s, device=x.device)
    valid = kj <= pos
    if window:
        valid &= kj > pos - window
    hkv = k.shape[2]
    group = cfg.n_heads // hkv
    qg = split_dim(q, 2, (hkv, group))
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * cfg.softmax_scale
    logits = logits.masked_fill(~valid, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    out = out.reshape(b, 1, cfg.n_heads, cfg.d_head).to(x.dtype)
    y = merge_heads(out, p.wo)
    return y, cache


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2 / MiniCPM3)
# --------------------------------------------------------------------------
class MLA(nn.Module):
    """`wq_a` [d, q_lora], `q_a_norm` [q_lora], `wq_b` [q_lora, H, qk]
    (with `q_lora_rank`; else `wq` [d, H, qk]), `wkv_a` [d, kv_lora +
    rope], `kv_a_norm` [kv_lora], `wk_b` [kv_lora, H, nope], `wv_b`
    [kv_lora, H, v], `wo` [H, v, d]."""

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        if cfg.q_lora_rank:
            self.wq_a = init.dense(d, cfg.q_lora_rank,
                                   axes=("embed", "q_lora"))
            self.q_a_norm = init.ones(cfg.q_lora_rank, axes=("q_lora",))
            self.wq_b = init.dense(cfg.q_lora_rank, nh, qk,
                                   axes=("q_lora", "heads", "head_dim"))
        else:
            self.wq = init.dense(d, nh, qk,
                                 axes=("embed", "heads", "head_dim"))
        self.wkv_a = init.dense(d, cfg.kv_lora_rank + cfg.qk_rope_dim,
                                axes=("embed", "kv_lora"))
        self.kv_a_norm = init.ones(cfg.kv_lora_rank, axes=("kv_lora",))
        self.wk_b = init.dense(cfg.kv_lora_rank, nh, cfg.qk_nope_dim,
                               axes=("kv_lora", "heads", "head_dim"))
        self.wv_b = init.dense(cfg.kv_lora_rank, nh, cfg.v_head_dim,
                               axes=("kv_lora", "heads", "head_dim"))
        self.wo = init.dense(nh, cfg.v_head_dim, d,
                             axes=("heads", "head_dim", "embed"))


def init_mla(init: ParamInit, cfg: ModelConfig) -> MLA:
    return MLA(init, cfg)


def _mla_q(p: MLA, cfg: ModelConfig, x):
    """-> q [B,S,H, qk_nope+qk_rope]."""
    if cfg.q_lora_rank:
        ql = rms_norm(fold_tokens(x, p.wq_a) @ p.wq_a, p.q_a_norm,
                      cfg.norm_eps)
        return project_heads(ql, p.wq_b)
    return project_heads(x, p.wq)


def _mla_kv_a(p: MLA, cfg: ModelConfig, x):
    """-> (normed latent c_kv [B,S,r], rope key [B,S,rope], unrotated)."""
    c_kv, k_rope = torch.split(fold_tokens(x, p.wkv_a) @ p.wkv_a,
                               [cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    return rms_norm(c_kv, p.kv_a_norm, cfg.norm_eps), k_rope


def mla_forward(p: MLA, cfg: ModelConfig, x, positions, *, causal=True,
                window: int = 0, tracer=NULL_TRACER):
    """`tracer` records the spans "attn.rope" and "attn.core"."""
    q_nope, q_rope = torch.split(_mla_q(p, cfg, x), [cfg.qk_nope_dim,
                                                     cfg.qk_rope_dim], dim=-1)
    c_kv, k_rope = _mla_kv_a(p, cfg, x)
    with tracer.span("attn.rope"):
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        k_rope = apply_rope(k_rope[:, :, None, :], positions,
                            cfg.rope_theta)
    k_nope = project_heads(c_kv, p.wk_b)
    v = project_heads(c_kv, p.wv_b)
    k_rope_b = k_rope.expand(*k_rope.shape[:2], cfg.n_heads,
                             cfg.qk_rope_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_b], dim=-1)
    with tracer.span("attn.core"):
        out = sdpa(q_full, k_full, v, causal=causal, window=window)
    return merge_heads(out, p.wo)


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}


def mla_decode(p: MLA, cfg: ModelConfig, x, cache, pos: int, *,
               absorb=False):
    """Latent-cached decode; the new latent and rope key are written into
    `cache` in place (as `gqa_decode` does).  absorb=True: W_UK folded
    into q and W_UV into the output, so attention works in the latent
    space."""
    b = x.shape[0]
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = torch.split(_mla_q(p, cfg, x), [cfg.qk_nope_dim,
                                                     cfg.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, posv, cfg.rope_theta)
    c_new, kr_new = _mla_kv_a(p, cfg, x)
    kr_new = apply_rope(kr_new[:, :, None, :], posv,
                        cfg.rope_theta)[:, :, 0, :]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    s = c_kv.shape[1]
    at = _slot(pos, s)
    write_slot(c_kv, at, c_new[:, 0])
    write_slot(k_rope, at, kr_new[:, 0])
    c_kv = shard(c_kv, "batch", "kv_seq", None)
    valid = torch.arange(s, device=x.device) <= pos
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    rope_logits = torch.einsum("bshk,btk->bhst", q_rope.float(),
                               k_rope.float())
    if absorb:
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p.wk_b)
        logits = torch.einsum("bshr,btr->bhst", q_lat.float(), c_kv.float())
        logits = (logits + rope_logits) * scale
        w = torch.softmax(logits.masked_fill(~valid, NEG_INF), dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", w, c_kv.float())
        out = torch.einsum("bshr,rhk->bshk", o_lat.to(x.dtype), p.wv_b)
    else:
        k_nope = project_heads(c_kv, p.wk_b)
        v = project_heads(c_kv, p.wv_b)
        logits = torch.einsum("bshk,bthk->bhst", q_nope.float(),
                              k_nope.float())
        logits = (logits + rope_logits) * scale
        w = torch.softmax(logits.masked_fill(~valid, NEG_INF), dim=-1)
        out = torch.einsum("bhst,bthk->bshk", w, v.float()).to(x.dtype)
    y = merge_heads(out, p.wo)
    return y, cache


# --------------------------------------------------------------------------
# Cross-attention (Whisper decoder)
# --------------------------------------------------------------------------
def init_cross(init: ParamInit, cfg: ModelConfig) -> GQA:
    return GQA(init, cfg)


def cross_forward(p: GQA, cfg: ModelConfig, x, enc_kv, *,
                  tracer=NULL_TRACER):
    """x: [B,Sd,D]; enc_kv: dict k/v [B,Se,H,D] (precomputed).  `tracer`
    records the span "attn.core"."""
    q = project_heads(x, p.wq)
    with tracer.span("attn.core"):
        out = sdpa(q, enc_kv["k"], enc_kv["v"], causal=False)
    return merge_heads(out, p.wo)


def cross_kv(p: GQA, cfg: ModelConfig, enc_out):
    return {"k": project_heads(enc_out, p.wk),
            "v": project_heads(enc_out, p.wv)}
