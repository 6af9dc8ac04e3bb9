"""Plain PyTorch version of the flash-attention kernel: causal GQA
attention with an fp32 softmax (the reference's `flash_attention_ref`)."""
from __future__ import annotations

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q: [B, Sq, H, D]; k/v: [B, Sk, Hkv, D] -> [B, Sq, H, D]."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    qg = q.reshape(b, sq, hkv, group, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * (d ** -0.5)
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)
