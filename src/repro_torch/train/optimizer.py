"""AdamW with fp32 master weights, global-norm clipping, and warmup+cosine
schedule (the port of the JAX package's `train/optimizer.py`).

Written on tensors, updating in place under `no_grad` (not
`torch.optim.AdamW`, which keeps no float32 master copy of bf16 params).
State is keyed by the parameter names of `Model.named_parameters()`; one
update is a few `torch._foreach_*` multi-tensor launches over every
parameter at once, in the reference's float32 order:
`new = base - lr * (mh / (sqrt(vh) + eps) + wd * base)`, then
`new.to(p.dtype)`.

The step count is a host int, so `lr` and the bias corrections are Python
floats (float64 on the host, rounded to float32 where they scale a
tensor) where the reference computes them in float32 on the device; no
step waits on the device for them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    master_fp32: bool = True


@dataclasses.dataclass
class OptState:
    """`m`, `v` (float32) and `master` (float32 params, or None when
    `master_fp32` is off), each keyed by parameter name; `step` counts the
    updates applied."""
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    master: Optional[Dict[str, torch.Tensor]]


def named_params(params) -> Dict[str, torch.Tensor]:
    """An `nn.Module`'s parameters, or a name -> tensor mapping, as a
    dict."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def lr_at(cfg: OptConfig, step: int) -> float:
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    frac = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(cfg: OptConfig, params) -> OptState:
    named = named_params(params)
    m = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()}
    v = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()}
    master = {n: p.detach().to(torch.float32, copy=True)
              for n, p in named.items()} if cfg.master_fp32 else None
    return OptState(step=0, m=m, v=v, master=master)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in float32 (a
    tensor on the gradients' device)."""
    gs = [g.float() for g in grads]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads: Mapping[str, torch.Tensor],
                  state: OptState):
    """One AdamW step over `params` (an `nn.Module` or a name -> tensor
    mapping) from `grads` (name -> gradient, any float dtype) ->
    (params, state, metrics {"grad_norm": float32 tensor, "lr": float}).
    The parameters and `state`'s tensors are updated in place; `grads`
    are not written."""
    named = named_params(params)
    names = list(named)
    ps = [named[n] for n in names]
    g32 = [grads[n].float() for n in names]
    gnorm = global_norm(g32)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0) \
        if cfg.clip_norm > 0 else 1.0
    g32 = torch._foreach_mul(g32, scale)      # new tensors: grads unwritten
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    ms = [state.m[n] for n in names]
    vs = [state.v[n] for n in names]
    torch._foreach_mul_(ms, cfg.b1)
    torch._foreach_add_(ms, g32, alpha=1 - cfg.b1)
    torch._foreach_mul_(vs, cfg.b2)
    torch._foreach_addcmul_(vs, g32, g32, value=1 - cfg.b2)
    # float32 params without a master copy are their own base
    base = [state.master[n] for n in names] if state.master is not None \
        else [p.float() for p in ps]
    den = torch._foreach_div(vs, b2c)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    upd = torch._foreach_div(ms, b1c)
    torch._foreach_div_(upd, den)
    if cfg.weight_decay:
        torch._foreach_add_(upd, base, alpha=cfg.weight_decay)
    torch._foreach_add_(base, upd, alpha=-lr)
    torch._foreach_copy_(ps, base)
    state.step = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
