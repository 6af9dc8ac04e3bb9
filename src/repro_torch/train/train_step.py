"""Train-step assembly: loss + grad + optimizer, with optional microbatch
gradient accumulation and int8 gradient compression (error feedback).
The port of the JAX package's `train/train_step.py`; `launch/steps.py`
runs it on DTensors for a mesh.

Gradients of each microbatch come from `torch.autograd.grad` and are added
into float32 buffers, then scaled by 1/n, as the reference's `lax.scan`
body adds `g.astype(float32)`: accumulating in `.grad` would sum in the
parameter dtype (bf16 on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ..configs.base import ModelConfig
from ..models import lm_loss
from ..models.model import Model
from ..parallel.collectives import compress_grads_inplace
from .optimizer import OptConfig, OptState, apply_updates


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    remat: str = "dots_no_batch"
    microbatches: int = 1            # gradient accumulation steps
    grad_compression: bool = False   # int8 error feedback (collectives.py)


class TrainState:
    """The model's parameters, the optimizer state and, with gradient
    compression, the error-feedback state (name -> float32 tensor)."""

    def __init__(self, params: Model, opt: OptState,
                 compress_err: Optional[Dict[str, torch.Tensor]] = None):
        self.params = params
        self.opt = opt
        self.compress_err = compress_err

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Every tensor of the state by checkpoint key: `params/<name>`
        (the model's `state_dict` names), `opt/step` (a 0-d int64 host
        tensor), `opt/{m,v,master}/<name>` and `compress_err/<name>`.
        The tensors are the live ones, except `opt/step`."""
        out = {f"params/{n}": p for n, p in self.params.named_parameters()}
        out["opt/step"] = torch.tensor(self.opt.step, dtype=torch.int64)
        for part in ("m", "v", "master"):
            for n, t in (getattr(self.opt, part) or {}).items():
                out[f"opt/{part}/{n}"] = t
        for n, t in (self.compress_err or {}).items():
            out[f"compress_err/{n}"] = t
        return out

    @torch.no_grad()
    def load_leaves(self, leaves: Dict[str, torch.Tensor]) -> "TrainState":
        """Copy `leaves` (keys as `leaves()` gives them) into this state's
        tensors in place; -> self.  A DTensor leaf takes its shard of a
        full tensor, or a DTensor redistributed to its placements."""
        for key, t in self.leaves().items():
            if key == "opt/step":
                self.opt.step = int(leaves[key])
            elif isinstance(t, DTensor):
                src = leaves[key]
                if not isinstance(src, DTensor):
                    src = distribute_tensor(src.to(t.to_local().device),
                                            t.device_mesh, t.placements,
                                            src_data_rank=None)
                t.to_local().copy_(src.redistribute(
                    t.device_mesh, t.placements).to_local())
            else:
                t.copy_(leaves[key])
        return self


def _split_microbatches(batch: Dict[str, Any], n: int
                        ) -> List[Dict[str, torch.Tensor]]:
    """A batch of tensors -> `n` microbatches of consecutive batch rows.
    positions3 is [3, B, S]: its batch axis is moved first for the split
    and back after, as in the reference."""
    def sp(x):
        if x.dim() >= 2 and x.shape[0] % n == 0 and x.shape[0] > 1:
            return x.reshape(n, x.shape[0] // n, *x.shape[1:])
        raise ValueError(f"cannot split batch dim {tuple(x.shape)} into {n}")
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if k == "positions3":
            out[k] = sp(v.movedim(1, 0)).movedim(2, 1)   # [n, 3, b, S]
        else:
            out[k] = sp(v)
    return [{k: v[i] for k, v in out.items()} for i in range(n)]


def loss_and_grads(cfg: ModelConfig, tc: TrainConfig, params: Model,
                   batch, *, place_grad=None):
    """-> (loss, {name: gradient}).  One microbatch: the loss and the
    gradients in the parameters' dtype, as the reference's
    `value_and_grad`.  Several: the mean loss and float32 gradients, each
    microbatch's added in float32 and the sum scaled by 1/n.  `batch` is
    one batch, or the list of its microbatches already split (a sharded
    step splits before placing them).  `place_grad(name, g)` places each
    microbatch's gradient (the sharded step's reduction to the
    parameter's placements)."""
    named = dict(params.named_parameters())

    def value_and_grad(b):
        loss = lm_loss(params, cfg, b, remat=tc.remat)
        grads = torch.autograd.grad(loss, list(named.values()))
        if place_grad is not None:
            grads = [place_grad(n, g) for n, g in zip(named, grads)]
        return loss, grads

    if tc.microbatches <= 1:
        loss, grads = value_and_grad(batch)
        return loss.detach(), dict(zip(named, grads))
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in named.values()]
    lsum = None
    mbs = batch if isinstance(batch, list) \
        else _split_microbatches(batch, tc.microbatches)
    for mb in mbs:
        loss, grads = value_and_grad(mb)
        torch._foreach_add_(acc, [g.float() for g in grads])
        lsum = loss.detach() if lsum is None else lsum + loss.detach()
    inv = 1.0 / tc.microbatches
    torch._foreach_mul_(acc, inv)
    return lsum * inv, dict(zip(named, acc))


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    tc: TrainConfig = TrainConfig()):
    """Returns train_step(state, batch) -> (state, metrics {"loss",
    "grad_norm": float32 tensors on the device, "lr": float}).  The state
    is updated in place and returned."""

    def train_step(state: TrainState, batch):
        loss, grads = loss_and_grads(cfg, tc, state.params, batch)
        if tc.grad_compression and state.compress_err is not None:
            grads, _ = compress_grads_inplace(grads, state.compress_err)
        _, _, metrics = apply_updates(opt_cfg, state.params, grads,
                                      state.opt)
        metrics["loss"] = loss
        return state, metrics

    return train_step
