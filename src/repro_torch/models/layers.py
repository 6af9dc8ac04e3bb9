"""Shared model layers: norms, activations, RoPE/M-RoPE, init helpers.

The port of the JAX package's `models/layers.py`.  Norms and RoPE compute
in float32 and cast back to the input's type, as there.  Parameters are
`nn.Parameter`s of small `nn.Module`s; the init helpers draw from an
explicit `torch.Generator` (`ParamInit`), which records each parameter's
logical axes beside it (`param_specs`), as the reference's `ParamBuilder`
records its spec tree.  The sharding hooks (`shard`, `set_shard_fn`,
`embedding_lookup`, `set_embed_lookup`) are the identity and a plain
gather until `parallel/sharding.py::install_activation_sharding` installs
the mesh-aware ones.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils._pytree import tree_map

from ..kernels.rms_norm import ops as norm_ops

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    return _DTYPES[name]


# --------------------------------------------------------------------------
# Parameter creation
# --------------------------------------------------------------------------
class ParamInit:
    """Draws parameters from one `torch.Generator` (the counterpart of the
    JAX `ParamBuilder`): normal with std `fan_in ** -0.5` (or `scale`),
    drawn in float32 and cast to `dtype`, placed on `device`.  Values are
    drawn on the generator's device and moved, so a CPU generator seeds a
    model on the card.  On the meta device nothing is drawn or allocated
    (shapes only).  Each parameter carries its logical axes (one name or
    None per dim, the reference's spec tuple; all None when not given) as
    `LOGICAL_AXES_ATTR`."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = device

    def _param(self, v: torch.Tensor, axes) -> nn.Parameter:
        p = nn.Parameter(v)
        axes = (None,) * v.dim() if axes is None else tuple(axes)
        if len(axes) != v.dim():
            raise ValueError(f"axes {axes} for a tensor of shape "
                             f"{tuple(v.shape)}")
        setattr(p, LOGICAL_AXES_ATTR, axes)
        return p

    def _meta(self) -> bool:
        return torch.device(self.device).type == "meta"

    def dense(self, *shape: int, axes: Optional[Tuple] = None,
              scale: Optional[float] = None) -> nn.Parameter:
        if self._meta():
            return self._param(torch.empty(shape, dtype=self.dtype,
                                           device="meta"), axes)
        fan_in = shape[0] if len(shape) > 1 else 1
        std = scale if scale is not None else fan_in ** -0.5
        v = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.generator.device) * std
        return self._param(v.to(self.device, self.dtype), axes)

    def zeros(self, *shape: int, axes: Optional[Tuple] = None
              ) -> nn.Parameter:
        return self._param(torch.zeros(shape, dtype=self.dtype,
                                       device=self.device), axes)

    def ones(self, *shape: int, axes: Optional[Tuple] = None
             ) -> nn.Parameter:
        return self._param(torch.ones(shape, dtype=self.dtype,
                                      device=self.device), axes)

    def const(self, value, *, axes: Optional[Tuple] = None
              ) -> nn.Parameter:
        """A fixed value cast to `dtype` (the reference's `pb.const`)."""
        return self._param(torch.as_tensor(value).to(self.device,
                                                     self.dtype), axes)


#: the attribute of a parameter that holds its logical axes
LOGICAL_AXES_ATTR = "logical_axes"


def param_specs(model: nn.Module) -> Dict[str, Tuple]:
    """-> {state_dict name: logical-axes tuple} for every parameter of
    `model`.  A block of a layer stack (`layers.<i>.attn.wq`) has the
    per-layer axes; the reference's stacked leaf has `"layers"` in front,
    which resolves to no mesh axis."""
    return {n: getattr(p, LOGICAL_AXES_ATTR)
            for n, p in model.named_parameters()}


# --------------------------------------------------------------------------
def rms_norm(x, weight, eps=1e-5):
    """The RMS norm over x's last dim (`kernels/rms_norm/ops.py`): the
    kernel for CUDA tensors, the eager float32 chain on the CPU and while
    autograd records a gradient."""
    return norm_ops.rms_norm(x, weight, eps)


def layer_norm(x, weight, bias, eps=1e-5):
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dtype)


class Norm(nn.Module):
    """`scale` (and `bias` for layernorm), named as the JAX params are."""

    def __init__(self, init: ParamInit, d: int, kind: str = "rmsnorm"):
        super().__init__()
        self.scale = init.ones(d, axes=("embed",))
        if kind == "layernorm":
            self.bias = init.zeros(d, axes=("embed",))


def norm(x, params: Norm, kind="rmsnorm", eps=1e-5):
    if kind == "rmsnorm":
        return rms_norm(x, params.scale, eps)
    return layer_norm(x, params.scale, params.bias, eps)


def activate(x_gate, x_up, act: str):
    """Gated/ungated MLP nonlinearity.  For non-GLU acts x_up is None.  A
    DTensor `x_up` takes `x_gate`'s placements first (`redistribute`)."""
    if isinstance(x_up, DTensor) and isinstance(x_gate, DTensor):
        x_up = redistribute(x_up, x_gate.placements)
    if act == "swiglu":
        return F.silu(x_gate) * x_up
    if act == "gelu":
        return F.gelu(x_gate, approximate="tanh")
    if act == "relu2":                     # squared ReLU (Nemotron/Primer)
        r = F.relu(x_gate)
        return r * r
    raise ValueError(act)


# --------------------------------------------------------------------------
# RoPE / M-RoPE
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2,
                                      dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _inv_freqs(head_dim: int, theta: float, device: torch.device):
    """`rope_freqs` on `device`, copied there once: a copy from pageable
    host memory waits for the device's stream to drain, which per call
    would stall every layer."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def _rotate(x, ang):
    """x [..., S, H, D] rotated by angles [..., S, D/2], in float32."""
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta=10000.0):
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    inv = _inv_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * inv)


def apply_mrope(x, positions3, sections, theta=10000.0):
    """Qwen2-VL M-RoPE: positions3 [3, ..., S] (t, h, w) indices; the rotary
    half-dims are partitioned into `sections` (t, h, w) groups."""
    d = x.shape[-1]
    inv = _inv_freqs(d, theta, x.device)
    sec = np.cumsum((0,) + tuple(sections))
    assert sec[-1] == d // 2, (sections, d)
    ang = torch.cat([positions3[i][..., None].float() * inv[sec[i]:sec[i + 1]]
                     for i in range(3)], dim=-1)
    return _rotate(x, ang)


def sinusoidal_positions(seq: int, d: int):
    """Whisper-style fixed sinusoidal embeddings [S, D] (float32, host)."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / (10000 ** (dim / d))
    out = np.zeros((seq, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out)


# --------------------------------------------------------------------------
# Sharding hooks: models call shard(x, names...) with logical names;
# parallel/sharding.py installs a mesh-aware resolver.
# --------------------------------------------------------------------------
_SHARD_FN = None
_EMBED_LOOKUP = None


def set_shard_fn(fn):
    """Install `fn(x, logical_axes) -> x` as the activation-sharding hook
    (None removes it)."""
    global _SHARD_FN
    _SHARD_FN = fn


def shard(x, *logical_axes):
    """Annotate `x` with one logical axis name (or None) per dim: the
    identity unless a hook is installed."""
    if _SHARD_FN is None:
        return x
    return _SHARD_FN(x, logical_axes)


def set_embed_lookup(fn):
    """Install a distributed embedding lookup `fn(table, tokens)` (the
    masked vocab-sharded gather of `parallel/sharding.py`; None removes
    it)."""
    global _EMBED_LOOKUP
    _EMBED_LOOKUP = fn


def embedding_lookup(table, tokens):
    if _EMBED_LOOKUP is None:
        return F.embedding(tokens, table)
    return _EMBED_LOOKUP(table, tokens)


# --------------------------------------------------------------------------
# DTensor helpers for the model's reshapes and products: the identity (or
# the plain op) on plain tensors
# --------------------------------------------------------------------------
def _even_shards(t: DTensor, dim: int, size0: int, inner=()) -> DTensor:
    """`t` with every shard of `dim` that `size0` does not divide, and every
    shard of the `inner` dims, replicated."""
    pl, factor = list(t.placements), 1
    for i, p in enumerate(pl):
        if any(p.is_shard(d) for d in inner):
            pl[i] = Replicate()
        elif p.is_shard(dim):
            n = t.device_mesh.size(i)
            if size0 % (factor * n):
                pl[i] = Replicate()
            else:
                factor *= n
    if pl != list(t.placements):
        t = t.redistribute(t.device_mesh, pl)
    return t


def _split(t: DTensor, dim: int, sizes) -> DTensor:
    return _even_shards(t, dim, sizes[0]).unflatten(dim, tuple(sizes))


def _merge(t: DTensor, start: int, end: int) -> DTensor:
    t = _even_shards(t, start, t.shape[start], range(start + 1, end + 1))
    local = t.to_local()
    if not local.is_contiguous():
        # DTensor lowers flatten to a view of the local shard, and judges
        # contiguity by the global strides only
        t = DTensor.from_local(local.contiguous(), t.device_mesh,
                               t.placements, run_check=False,
                               shape=t.shape, stride=t.stride())
    return t.flatten(start, end)


class _SplitDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, sizes):
        ctx.span = (dim, dim + len(sizes) - 1)
        return _split(t, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        return _merge(g, *ctx.span), None, None


class _MergeDims(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, start, end):
        ctx.start, ctx.sizes = start, tuple(t.shape[start:end + 1])
        return _merge(t, start, end)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.start, ctx.sizes), None, None


def split_dim(t, dim: int, sizes):
    """`t.unflatten(dim, sizes)`.  On a DTensor, a shard of `dim` over mesh
    dims that `sizes[0]` does not divide (9 heads over 16) is replicated
    first, in the forward and the backward pass: DTensor cannot split or
    merge an uneven shard, and SPMD would all-gather there too."""
    if not isinstance(t, DTensor):
        return t.unflatten(dim, tuple(sizes))
    return _SplitDim.apply(t, dim % t.dim(), tuple(sizes))


def merge_dims(t, start: int, end: int):
    """`t.flatten(start, end)`, on a DTensor with the same care as
    `split_dim` (shards of the inner dims are replicated first)."""
    if not isinstance(t, DTensor):
        return t.flatten(start, end)
    return _MergeDims.apply(t, start % t.dim(), end % t.dim())


class _Redistribute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pl):
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        return x.redistribute(x.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.back), None


def redistribute(x: DTensor, pl) -> DTensor:
    """`x.redistribute` to placements `pl`, whose gradient goes back to
    `x`'s own placements (replicated where `x` was a partial sum): the
    product that made `x` then sees its gradient sharded as its output
    was.  DTensor's own backward of a redistribution may leave the
    gradient replicated, and each rank then computes a whole weight
    gradient."""
    if tuple(x.placements) == tuple(pl):
        return x
    return _Redistribute.apply(x, tuple(pl))


def fold_tokens(x, w=None):
    """`x` [B, S, ..., d] ready for the matrix product `x @ w`, which folds
    its leading dims into one (a view [B*S, d]).  On a DTensor, a shard of
    a leading dim after the first cannot be folded (DTensor cannot merge
    batch sharded over `data` with sequence sharded over `model`): where
    `w`'s contracting dim is sharded over the same mesh dim, the shard
    moves to `x`'s last dim (an all-to-all; the product is then a partial
    sum there, Megatron's sequence -> tensor parallel hand-off), else it is
    replicated (an all-gather).  The identity on a plain tensor."""
    if not isinstance(x, DTensor) or x.dim() <= 2:
        return x
    last = x.dim() - 1
    pl, moved = list(x.placements), False
    for i, p in enumerate(pl):
        if not any(p.is_shard(d) for d in range(1, last)):
            continue
        k_sharded = isinstance(w, DTensor) and w.placements[i].is_shard(0)
        if k_sharded and x.shape[last] % x.device_mesh.size(i) == 0 \
                and not any(q.is_shard(last) for q in pl):
            pl[i], moved = Shard(last), True
        else:
            pl[i], moved = Replicate(), True
    return redistribute(x, pl) if moved else x


def project_heads(x, w):
    """x [B, S, d] by w [d, H, K] -> [B, S, H, K], the reference's einsum
    "bsd,dhk->bshk", as one matrix product over the flattened (H, K) and
    a `split_dim`: on DTensors the einsum's own unflatten of (H, K) fails
    when DTensor shards it over a mesh dim that H does not divide."""
    w2 = merge_dims(w, 1, 2)
    return split_dim(fold_tokens(x, w2) @ w2, -1, w.shape[1:])


def merge_heads(o, w):
    """o [B, S, H, K] by w [H, K, d] -> [B, S, d], the einsum
    "bshk,hkd->bsd", over the flattened (H, K) as `project_heads`."""
    w2 = merge_dims(w, 0, 1)
    return fold_tokens(merge_dims(o, -2, -1), w2) @ w2


def replicated_call(fn, *args):
    """`fn(*args)`, or, when an argument is a DTensor, `fn` on every
    rank's replicated values: each DTensor argument is redistributed to
    replicated (an explicit all-gather, where SPMD would insert one) and
    each tensor `fn` returns is a replicated DTensor.  For the routing
    steps (top-k, scatter, gather) that have no sharding rule."""
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    rep = [Replicate()] * mesh.ndim
    local = [a.redistribute(mesh, rep).to_local()
             if isinstance(a, DTensor) else a for a in args]
    return tree_map(lambda o: DTensor.from_local(o, mesh, rep,
                                                 run_check=False)
                    if isinstance(o, torch.Tensor) else o, fn(*local))
