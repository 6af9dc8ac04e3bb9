"""Mixture-of-Experts FFN: top-k token-choice routing, with fixed capacity
or dropless.

The port of the JAX package's `models/moe.py`.  Dispatch is scatter-based
(sort-free): positions within each expert's buffer come from an exclusive
cumsum over the one-hot assignment, and tokens beyond capacity are dropped
(GShard-style).  Shared experts (DeepSeekMoE) run densely on every token.
The batched expert products are plain `einsum`s, as the reference's are
(no Pallas kernel there).  `parallel/sharding.py` installs the
expert-parallel hook (`set_moe_ep_impl`: local dispatch and an
all-to-all over `model`); on DTensors the global path routes, dispatches
and combines on replicated values (`layers.replicated_call`).

A dropless configuration (`capacity_factor` 0, `cfg.dropless`; the port's
own, for Granite 4.0-H) takes `_moe_mlp_dropless` instead: the T*k
assignments sorted by expert on the device, every token's rows gathered,
the experts' products as grouped products over the per-expert row offsets
(`kernels/moe_grouped`), the rows weighted by their gates and summed back
a token.  No capacity and no host sync; it runs on one device (DTensors
raise).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..kernels.moe_grouped import ops as grouped_ops
from ..obs.trace import NULL_TRACER
from .layers import (ParamInit, activate, fold_tokens, replicated_call,
                     shard)


class DenseMLP(nn.Module):
    """`w_gate` [d, d_ff], `w_up` [d, d_ff] (SwiGLU only), `w_down`
    [d_ff, d]."""

    def __init__(self, init: ParamInit, cfg: ModelConfig, d_ff: int):
        super().__init__()
        d = cfg.d_model
        self.w_gate = init.dense(d, d_ff, axes=("embed", "ff"))
        if cfg.act == "swiglu":
            self.w_up = init.dense(d, d_ff, axes=("embed", "ff"))
        self.w_down = init.dense(d_ff, d, axes=("ff", "embed"))


def init_dense_mlp(init: ParamInit, cfg: ModelConfig, d_ff: int) -> DenseMLP:
    return DenseMLP(init, cfg, d_ff)


def dense_mlp(p: DenseMLP, cfg: ModelConfig, x, d_ff=None):
    x = fold_tokens(x, p.w_gate)
    g = shard(x @ p.w_gate, "batch", "seq", "ff")
    up = x @ p.w_up if cfg.act == "swiglu" else None
    h = activate(g, up, cfg.act)
    return shard(fold_tokens(h, p.w_down) @ p.w_down, "batch", "seq", "embed")


class MoE(nn.Module):
    """`router` [d, E] (std 0.02), `w_gate`/`w_up` [E, d, f] (`w_up` for
    SwiGLU only), `w_down` [E, f, d], and `shared`, a `DenseMLP` of width
    `cfg.d_shared_expert` (`d_shared`, else `d_expert * n_shared_experts`)
    when the config has shared experts."""

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
        self.router = init.dense(d, e, axes=("embed", "experts"),
                                 scale=0.02)
        # expert weights shard on the expert dim only, so the grouped
        # product against [E, C, d] buffers is local
        self.w_gate = init.dense(e, d, f, axes=("experts", None, None))
        if cfg.act == "swiglu":
            self.w_up = init.dense(e, d, f, axes=("experts", None, None))
        self.w_down = init.dense(e, f, d, axes=("experts", None, None))
        if cfg.n_shared_experts:
            self.shared = DenseMLP(init, cfg, cfg.d_shared_expert)


def init_moe(init: ParamInit, cfg: ModelConfig) -> MoE:
    return MoE(init, cfg)


# Hook for explicit expert-parallel execution (parallel/sharding.py);
# None, or a None result => the global path below.
_MOE_EP_IMPL = None


def set_moe_ep_impl(fn):
    global _MOE_EP_IMPL
    _MOE_EP_IMPL = fn


def moe_mlp(p: MoE, cfg: ModelConfig, x, *, tracer=NULL_TRACER):
    """x: [B,S,D] -> [B,S,D].  `tracer` records the dropless path's spans
    "moe.route", "moe.dispatch", "moe.experts", "moe.combine" and
    "moe.shared"."""
    if cfg.dropless:
        return _moe_mlp_dropless(p, cfg, x, tracer)
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


def expert_ffn(buf, p: MoE, cfg: ModelConfig, *, annotate: bool = False):
    """buf: [E, C, d] through each expert's MLP -> [E, C, d].  `annotate`
    marks the gate product's sharding (the global path's)."""
    g = torch.einsum("ecd,edf->ecf", buf, p.w_gate)
    if annotate:
        g = shard(g, "experts", "moe_cap", None)
    up = torch.einsum("ecd,edf->ecf", buf, p.w_up) \
        if cfg.act == "swiglu" else None
    h = activate(g, up, cfg.act)
    return torch.einsum("ecf,efd->ecd", h, p.w_down)


def _moe_mlp_global(p: MoE, cfg: ModelConfig, x):
    b, s, d = x.shape
    t = b * s
    cap = capacity(cfg, t)
    # routing, dispatch and combine on replicated values when x is a
    # DTensor (`replicated_call`); the expert products on the shards
    buf, route = replicated_call(
        lambda xx, router: moe_local_route_dispatch(xx.reshape(t, d), router,
                                                    cfg, cap),
        x, p.router)
    buf = shard(buf, "experts", "moe_cap", None)
    out_buf = shard(expert_ffn(buf, p, cfg, annotate=True),
                    "experts", "moe_cap", None)
    y = replicated_call(
        lambda ob, *rt: moe_combine(ob, rt, t, cfg.top_k, d, cap),
        out_buf, *route).reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + dense_mlp(p.shared, cfg, x)
    return y


def sort_by_expert(flat_e, n_experts: int):
    """Assignments' expert ids [T*k] -> (order [T*k], the assignments
    sorted by expert, stably; offs [E] int32, the end of each expert's
    rows in that order), all on the device: no host sync."""
    sorted_e, order = torch.sort(flat_e, stable=True)
    experts = torch.arange(n_experts, device=flat_e.device,
                           dtype=sorted_e.dtype)
    offs = torch.searchsorted(sorted_e, experts, right=True)
    return order, offs.to(torch.int32)


def _moe_mlp_dropless(p: MoE, cfg: ModelConfig, x, tr=NULL_TRACER):
    """Every token through its top-k experts: route, sort the T*k
    assignments by expert, gather their rows, the experts' gate/up and
    down products grouped over the per-expert offsets, then a token's k
    rows summed by their gates in one batched product of the activations'
    type (the gates rounded to it: bf16 on the card, where the plain
    reference weights in float32)."""
    if isinstance(x, DTensor) or isinstance(p.router, DTensor):
        raise NotImplementedError(
            f"{cfg.name}: the dropless MoE runs on one device; sharded "
            f"(DTensor) inputs or experts are not supported")
    b, s, d = x.shape
    t, k = b * s, cfg.top_k
    xt = x.reshape(t, d)
    with tr.span("moe.route"):
        _, top_p, top_i = _route(xt, p.router, cfg)
    with tr.span("moe.dispatch"):
        order, offs = sort_by_expert(top_i.reshape(-1), cfg.n_experts)
        rows = xt.index_select(0, order // k)                 # [T*k, d]
    with tr.span("moe.experts"):
        g = grouped_ops.grouped_mm(rows, p.w_gate, offs)
        up = grouped_ops.grouped_mm(rows, p.w_up, offs) \
            if cfg.act == "swiglu" else None
        out = grouped_ops.grouped_mm(activate(g, up, cfg.act), p.w_down,
                                     offs)
    with tr.span("moe.combine"):
        # back to token order by the inverse permutation (a gather), then
        # each token's k rows summed by their gates in one batched product
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=order.device)
        y = out.index_select(0, inv).view(t, k, d)
        y = torch.bmm(top_p.to(y.dtype)[:, None, :], y)[:, 0]
    if cfg.n_shared_experts:
        with tr.span("moe.shared"):
            y = y + dense_mlp(p.shared, cfg, x).reshape(t, d)
    return y.reshape(b, s, d)


def aux_load_balance_loss(p: MoE, cfg: ModelConfig, x):
    """Switch-style load-balance auxiliary loss (importance * load)."""
    xt = x.reshape(-1, x.shape[-1])
    probs, _, top_i = _route(xt, p.router, cfg)
    load = F.one_hot(top_i, cfg.n_experts).float().sum(1).mean(0)
    importance = probs.mean(0)
    return cfg.n_experts * torch.sum(load * importance)
