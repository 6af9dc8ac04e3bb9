"""The dense MLP of the JAX package's `models/moe.py` (`init_dense_mlp`,
`dense_mlp`).  Routed mixture-of-experts (`init_moe`, `moe_mlp`) is not
ported yet (ROADMAP queue 1, item 7)."""
from __future__ import annotations

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
