"""Mixture-of-Experts FFN: top-k token-choice routing with fixed capacity.

The port of the JAX package's `models/moe.py`.  Dispatch is scatter-based
(sort-free): positions within each expert's buffer come from an exclusive
cumsum over the one-hot assignment, and tokens beyond capacity are dropped
(GShard-style).  Shared experts (DeepSeekMoE) run densely on every token.
The batched expert products are plain `einsum`s, as the reference's are
(no Pallas kernel there).  The expert-parallel hook (`set_moe_ep_impl`)
stays `None` until the parallel slice is ported (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .layers import ParamInit, activate


class DenseMLP(nn.Module):
    """`w_gate` [d, d_ff], `w_up` [d, d_ff] (SwiGLU only), `w_down`
    [d_ff, d]."""

    def __init__(self, init: ParamInit, cfg: ModelConfig, d_ff: int):
        super().__init__()
        d = cfg.d_model
        self.w_gate = init.dense(d, d_ff)
        if cfg.act == "swiglu":
            self.w_up = init.dense(d, d_ff)
        self.w_down = init.dense(d_ff, d)


def init_dense_mlp(init: ParamInit, cfg: ModelConfig, d_ff: int) -> DenseMLP:
    return DenseMLP(init, cfg, d_ff)


def dense_mlp(p: DenseMLP, cfg: ModelConfig, x, d_ff=None):
    g = x @ p.w_gate
    up = x @ p.w_up if cfg.act == "swiglu" else None
    h = activate(g, up, cfg.act)
    return h @ p.w_down


class MoE(nn.Module):
    """`router` [d, E] (std 0.02), `w_gate`/`w_up` [E, d, f] (`w_up` for
    SwiGLU only), `w_down` [E, f, d], and `shared`, a `DenseMLP` of width
    `d_expert * n_shared_experts` when the config has shared experts."""

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
        self.router = init.dense(d, e, scale=0.02)
        self.w_gate = init.dense(e, d, f)
        if cfg.act == "swiglu":
            self.w_up = init.dense(e, d, f)
        self.w_down = init.dense(e, f, d)
        if cfg.n_shared_experts:
            self.shared = DenseMLP(init, cfg,
                                   cfg.d_expert * cfg.n_shared_experts)


def init_moe(init: ParamInit, cfg: ModelConfig) -> MoE:
    return MoE(init, cfg)


# Hook for explicit expert-parallel execution (the parallel slice);
# None => the single-device path below.
_MOE_EP_IMPL = None


def set_moe_ep_impl(fn):
    global _MOE_EP_IMPL
    _MOE_EP_IMPL = fn


def moe_mlp(p: MoE, cfg: ModelConfig, x):
    """x: [B,S,D] -> [B,S,D]."""
    if _MOE_EP_IMPL is not None:
        y = _MOE_EP_IMPL(p, cfg, x)
        if y is not None:
            if cfg.n_shared_experts:
                y = y + dense_mlp(p.shared, cfg, x)
            return y
    return _moe_mlp_global(p, cfg, x)


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots per expert for `t` tokens: the reference's formula, a float
    floor-divided and truncated."""
    k = cfg.top_k
    return int(max(k, (t * k * cfg.capacity_factor) // cfg.n_experts))


def _route(xt, router, cfg: ModelConfig):
    """-> (router probs [T, E] float32, top-k probs renormalised [T, k],
    top-k expert ids [T, k]).  `torch.topk` sorts descending as
    `lax.top_k` does; on ties the two may pick different experts."""
    probs = torch.softmax((xt @ router).float(), dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return probs, top_p, top_i


def moe_local_route_dispatch(xt, router, cfg: ModelConfig, cap: int):
    """Routing + capacity dispatch of a flat token slab [T, d] into
    per-expert buffers [E, cap, d] -> (buf, route)."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    _, top_p, top_i = _route(xt, router, cfg)
    flat_e = top_i.reshape(-1)                            # [T*k]
    # each assignment's slot: the earlier assignments to its expert (the
    # reference's exclusive cumsum of the one-hot [T*k, E] over dim 0).
    # Counted along the last axis of [E, T*k], where the card's scan runs
    # in parallel; over dim 0 it walks T*k rows per expert in turn
    onehot = F.one_hot(flat_e, e).T.contiguous()          # [E, T*k]
    flat_pos = torch.cumsum(onehot, dim=1).gather(0, flat_e[None])[0] - 1
    keep = flat_pos < cap
    # every token over capacity lands in slot cap-1 as zeros: accumulate,
    # so that it does not overwrite the token kept there
    src = xt.repeat_interleave(k, dim=0).masked_fill(~keep[:, None], 0)
    buf = torch.zeros((e, cap, d), dtype=xt.dtype, device=xt.device)
    buf.index_put_((flat_e, torch.clamp_max(flat_pos, cap - 1)), src,
                   accumulate=True)
    return buf, (flat_e, flat_pos, keep, top_p)


def moe_combine(out_buf, route, t: int, k: int, d: int, cap: int):
    """Expert outputs [E, cap, d] back to tokens [T, d], weighted by the
    renormalised routing probabilities; dropped tokens get zero."""
    flat_e, flat_pos, keep, top_p = route
    gathered = out_buf[flat_e, torch.clamp_max(flat_pos, cap - 1)]
    gathered = gathered.masked_fill(~keep[:, None], 0)
    w = top_p.reshape(-1)[:, None].to(gathered.dtype)
    return (gathered * w).reshape(t, k, d).sum(dim=1)


def expert_ffn(buf, p: MoE, cfg: ModelConfig):
    """buf: [E, C, d] through each expert's MLP -> [E, C, d]."""
    g = torch.einsum("ecd,edf->ecf", buf, p.w_gate)
    up = torch.einsum("ecd,edf->ecf", buf, p.w_up) \
        if cfg.act == "swiglu" else None
    h = activate(g, up, cfg.act)
    return torch.einsum("ecf,efd->ecd", h, p.w_down)


def _moe_mlp_global(p: MoE, cfg: ModelConfig, x):
    b, s, d = x.shape
    t = b * s
    cap = capacity(cfg, t)
    buf, route = moe_local_route_dispatch(x.reshape(t, d), p.router, cfg,
                                          cap)
    out_buf = expert_ffn(buf, p, cfg)
    y = moe_combine(out_buf, route, t, cfg.top_k, d, cap).reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + dense_mlp(p.shared, cfg, x)
    return y


def aux_load_balance_loss(p: MoE, cfg: ModelConfig, x):
    """Switch-style load-balance auxiliary loss (importance * load)."""
    xt = x.reshape(-1, x.shape[-1])
    probs, _, top_i = _route(xt, p.router, cfg)
    load = F.one_hot(top_i, cfg.n_experts).float().sum(1).mean(0)
    importance = probs.mean(0)
    return cfg.n_experts * torch.sum(load * importance)
