"""Logical-axis sharding rules: FSDP x TP x EP x SP on the (pod, data,
model) mesh, on DTensor (the port of the JAX package's
`parallel/sharding.py`).

Every model parameter carries a tuple of logical axis names
(`models/layers.py::ParamInit`, `param_specs`); activations are annotated
in-model through the `layers.shard` hook.  Resolution maps logical -> mesh
axes with divisibility fallback (a dim that does not divide its mesh axis
is replicated).  A resolved spec is a `PartitionSpec` (one entry per
tensor dim, as `jax.sharding.PartitionSpec` has), and `placements` turns
it into DTensor placements, one per mesh dim; the counterpart of a GSPMD
sharding constraint is a `DTensor.redistribute` to them.

Default rules:
  vocab/ff/heads/experts/ssm_inner -> model   (tensor / expert parallel)
  embed                            -> data    (FSDP: params sharded over dp)
  batch                            -> (pod, data)
  kv_seq                           -> data, else model (decode: shard the
                                               KV cache sequence)
  seq                              -> data for long-context (SP), then model

The counterparts of the reference's `shard_map` regions (the expert-
parallel MoE and the vocab-sharded embedding lookup) run per rank through
`torch.distributed.tensor.experimental.local_map` with explicit
collectives over the `model` sub-mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from .local_shards import as_dtensor
from ..models import layers as layers_mod

MODEL_AXES = ("vocab", "ff", "heads", "experts", "ssm_inner",
              "ssm_heads")


class PartitionSpec(tuple):
    """One mesh-axis entry per tensor dim (None, an axis name, or a tuple
    of names), trailing Nones dropped: `jax.sharding.PartitionSpec`'s
    entries, so the two compare entry for entry as tuples."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _norm_axes(axes):
    """Canonicalize a mesh-axis assignment: a 1-element tuple is the bare
    axis name."""
    if isinstance(axes, tuple):
        if not axes:
            return None
        if len(axes) == 1:
            return axes[0]
    return axes


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a `DeviceMesh`, of a mapping, or of any object
    with a `shape` mapping (a shape-only stand-in)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh_axes: Tuple[str, ...]
    fsdp: bool = True                 # shard 'embed' param dim over data
    seq_shard: bool = False           # sequence parallelism for activations
    table: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def resolve(self, logical: Optional[str]):
        if logical in self.table:
            return self.table[logical]
        if logical is None:
            return None
        if logical in MODEL_AXES or logical == "kv_heads":
            return "model" if "model" in self.mesh_axes else None
        if logical == "embed":
            return "data" if (self.fsdp and "data" in self.mesh_axes) \
                else None
        if logical == "batch":
            return _norm_axes(tuple(a for a in ("pod", "data")
                                    if a in self.mesh_axes))
        if logical == "moe_cap":
            # expert-capacity dim: data axes (tokens were batch-sharded)
            return [_norm_axes(tuple(a for a in ("pod", "data")
                                     if a in self.mesh_axes))]
        if logical == "kv_seq":
            # candidates in order: the KV seq dim takes whichever axis the
            # batch/head dims left free (flash-decode style seq sharding)
            return [a for a in ("data", "model") if a in self.mesh_axes]
        if logical == "seq":
            # Megatron-style SP over 'model' at block boundaries; with
            # seq_shard (long context, tiny batch) the data axes first
            cands = []
            if self.seq_shard:
                axes = _norm_axes(tuple(a for a in ("pod", "data")
                                        if a in self.mesh_axes))
                if axes:
                    cands.append(axes)
            if "model" in self.mesh_axes:
                cands.append("model")
            return cands or None
        return None


def make_rules(mesh, *, fsdp: bool = True, seq_shard: bool = False,
               overrides: Optional[Dict[str, Any]] = None) -> ShardingRules:
    return ShardingRules(mesh_axes=tuple(mesh_axis_sizes(mesh)), fsdp=fsdp,
                         seq_shard=seq_shard, table=dict(overrides or {}))


def _axis_size(sizes: Dict[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return int(math.prod(sizes[a] for a in axis))
    return sizes[axis]


def spec_to_pspec(spec: Tuple, shape: Optional[Tuple[int, ...]],
                  rules: ShardingRules, mesh) -> PartitionSpec:
    """Logical spec + concrete shape -> PartitionSpec with divisibility and
    duplicate-axis fallbacks."""
    sizes = mesh_axis_sizes(mesh)
    used = set()
    out = []
    if shape is not None and len(spec) != len(shape):
        # rank mismatch (a flattened call site): annotate by trailing
        # alignment, replicating unmatched leading dims
        spec = ((None,) * max(0, len(shape) - len(spec))
                + tuple(spec)[-len(shape):] if len(shape) else ())
    for i, logical in enumerate(spec):
        axis = rules.resolve(logical)
        candidates = axis if isinstance(axis, list) else [axis]
        chosen = None
        for cand in candidates:
            flat = tuple(cand) if isinstance(cand, tuple) else (cand,)
            if cand is None or any(a in used for a in flat if a):
                continue
            if shape is not None and shape[i] % _axis_size(sizes, cand):
                continue              # non-divisible -> next candidate
            used.update(a for a in flat if a)
            chosen = cand
            break
        out.append(chosen)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def placements(pspec: Sequence, mesh) -> List:
    """A PartitionSpec -> DTensor placements, one per mesh dim of `mesh`
    (a `DeviceMesh`, or anything with named axes): tensor dim d sharded
    over axis a is `Shard(d)` on a's mesh dim; a tuple entry shards d over
    each of its axes, outer first, which is JAX's major-to-minor layout
    when the tuple follows the mesh's axis order.  A mesh dim of size 1
    holds the whole tensor either way and stays `Replicate` (DTensor would
    otherwise refuse views that drop or merge such a "sharded" dim)."""
    sizes = mesh_axis_sizes(mesh)
    names = list(sizes)
    out: List = [Replicate() for _ in names]
    for d, entry in enumerate(pspec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{entry}: axes must follow the mesh's order "
                             f"{tuple(names)}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return out


def logical_placements(spec: Tuple, shape, rules: ShardingRules, mesh):
    """Logical spec + shape -> DTensor placements on `mesh`."""
    return placements(spec_to_pspec(tuple(spec), tuple(shape), rules,
                                     mesh), mesh)


def param_shardings(specs: Mapping[str, Tuple],
                    shapes: Mapping[str, Sequence[int]],
                    rules: ShardingRules, mesh) -> Dict[str, PartitionSpec]:
    """{name: PartitionSpec} for every parameter (`specs` as
    `layers.param_specs` gives them, `shapes` name -> shape)."""
    return {n: spec_to_pspec(tuple(specs[n]), tuple(shapes[n]), rules, mesh)
            for n in specs}


def batch_pspec(rules: ShardingRules, mesh) -> PartitionSpec:
    return P(rules.resolve("batch"))


def distribute(t: torch.Tensor, mesh, pl) -> DTensor:
    """A full tensor (the same on every rank) -> a DTensor of placements
    `pl`: each rank keeps its slice (`src_data_rank=None`), nothing is
    communicated."""
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


# --------------------------------------------------------------------------
# Activation sharding hooks
# --------------------------------------------------------------------------
def constrain(x, logical_axes, mesh, rules: ShardingRules):
    """The counterpart of `with_sharding_constraint`: a DTensor is
    redistributed to the resolved placements; a plain tensor is left
    alone."""
    if not isinstance(x, DTensor):
        return x
    pl = logical_placements(logical_axes, x.shape, rules, mesh)
    if tuple(x.placements) == tuple(pl):
        return x
    return layers_mod.redistribute(x, pl)


def install_activation_sharding(mesh, rules: ShardingRules):
    """Activate the in-model shard() hook, the distributed embedding
    lookup and the expert-parallel MoE.  Step builders install it for the
    length of one call and clear it in `finally`."""
    from ..models import moe as moe_mod
    layers_mod.set_shard_fn(lambda x, axes: constrain(x, axes, mesh, rules))
    layers_mod.set_embed_lookup(
        lambda table, tokens: masked_embedding_lookup(table, tokens, mesh,
                                                      rules))
    moe_mod.set_moe_ep_impl(
        lambda p, cfg, x: moe_ep_shard_map(p, cfg, x, mesh, rules))


def clear_activation_sharding():
    from ..models import moe as moe_mod
    layers_mod.set_shard_fn(None)
    layers_mod.set_embed_lookup(None)
    moe_mod.set_moe_ep_impl(None)


class activation_sharding:
    """`with activation_sharding(mesh, rules):` installs the hooks and
    clears them on exit, also on an error."""

    def __init__(self, mesh, rules: ShardingRules):
        self.mesh, self.rules = mesh, rules

    def __enter__(self):
        install_activation_sharding(self.mesh, self.rules)
        return self

    def __exit__(self, *exc):
        clear_activation_sharding()
        return False


# --------------------------------------------------------------------------
# Expert parallelism
# --------------------------------------------------------------------------
def _model_dim(mesh) -> int:
    return list(mesh.mesh_dim_names).index("model")


def _a2a(x: torch.Tensor, mesh) -> torch.Tensor:
    """Equal-split all-to-all of dim 0 over the `model` sub-mesh
    (differentiable)."""
    out = funcol.all_to_all_single_autograd(x.contiguous(), None, None,
                                            (mesh, _model_dim(mesh)))
    return funcol.wait_tensor(out) if hasattr(funcol, "wait_tensor") \
        else out


def moe_ep_shard_map(p, cfg, x, mesh, rules: ShardingRules):
    """Explicit expert parallelism: tokens stay (batch x seq)-sharded; each
    rank routes + dispatches its local slab into [E, C_loc, d] buffers,
    one all-to-all over 'model' regroups them into [E/ep, C_loc*ep, d]
    slabs matched to the local expert weight shards, and the reverse
    all-to-all brings expert outputs home for the weighted combine.
    Returns None (the caller falls back to the global path) when the
    mesh/shapes don't fit the pattern, or when `x` is not a DTensor."""
    from ..models import moe as moe_mod

    sizes = mesh_axis_sizes(mesh)
    if not isinstance(x, DTensor) or "model" not in sizes:
        return None
    e = cfg.n_experts
    ep = sizes["model"]
    b, s, d = x.shape
    if e % ep != 0 or s % ep != 0 or s <= 1:
        return None
    batch_axes = rules.resolve("batch")
    flat = batch_axes if isinstance(batch_axes, tuple) else (batch_axes,)
    n_dp = _axis_size(sizes, batch_axes)
    if b % n_dp != 0 or "model" in flat:
        return None
    t_loc = (b // n_dp) * (s // ep)
    cap = moe_mod.capacity(cfg, t_loc)
    has_up = hasattr(p, "w_up")
    k = cfg.top_k

    def local(x_loc, router, *ws):
        wg, wd = ws[0], ws[-1]
        wu = ws[1] if has_up else None
        bl, sl, _ = x_loc.shape
        xt = x_loc.reshape(bl * sl, d)
        buf, route = moe_mod.moe_local_route_dispatch(xt, router, cfg, cap)
        # [E, C, d] -> [E/ep, C*ep, d]: expert slabs to their owners
        got = _a2a(buf, mesh).reshape(ep, e // ep, cap, d)
        buf = got.transpose(0, 1).reshape(e // ep, ep * cap, d)
        out = moe_mod.expert_ffn(buf, _Experts(wg, wu, wd), cfg)
        out = out.reshape(e // ep, ep, cap, d).transpose(0, 1)
        out = _a2a(out, mesh).reshape(e, cap, d)
        y = moe_mod.moe_combine(out, route, bl * sl, k, d, cap)
        return y.reshape(bl, sl, d)

    xpl = placements(P(batch_axes, "model", None), mesh)
    wpl = placements(P("model", None, None), mesh)
    rpl = [Replicate()] * mesh.ndim
    ws = (p.w_gate, p.w_up, p.w_down) if has_up else (p.w_gate, p.w_down)
    in_pl = (xpl, rpl) + (wpl,) * len(ws)
    fn = local_map(local, out_placements=xpl, in_placements=in_pl,
                   in_grad_placements=tuple(_grad_placements(pl, xpl)
                                            for pl in in_pl),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, as_dtensor(p.router, mesh), *ws)


def _grad_placements(pl, data_pl) -> list:
    """The placements of an input's local gradient in a `local_map` region
    whose data (`data_pl`) is sharded: replicated over a mesh dim where
    the data is sharded, each rank holds only its data's contribution, so
    the gradient is `Partial` (summed) there."""
    return [Partial() if p.is_replicate() and d.is_shard() else p
            for p, d in zip(pl, data_pl)]


class _Experts:
    """The expert weights of one rank, as `expert_ffn` reads them."""

    def __init__(self, w_gate, w_up, w_down):
        self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down


# --------------------------------------------------------------------------
# Vocab-sharded embedding lookup
# --------------------------------------------------------------------------
def masked_embedding_lookup(table, tokens, mesh, rules: ShardingRules):
    """Gather from a vocab-sharded table without replicating it: each model
    shard gathers its local rows (out-of-range tokens clamped and masked
    to zero) and an all-reduce over 'model' assembles the row.  A plain
    gather when the table is not a DTensor or the vocab doesn't divide the
    model axis (the table is then replicated by the divisibility rule)."""
    sizes = mesh_axis_sizes(mesh)
    vocab = table.shape[0]
    if not isinstance(table, DTensor) or "model" not in sizes \
            or vocab % sizes["model"] != 0:
        return F.embedding(as_dtensor(tokens, mesh)
                           if isinstance(table, DTensor) else tokens, table)
    tok_spec = spec_to_pspec(("batch",) + (None,) * (tokens.dim() - 1),
                             tokens.shape, rules, mesh)
    tok_pl = placements(tok_spec, mesh)
    md = _model_dim(mesh)
    if tok_pl[md].is_shard():         # tokens split over 'model' too
        return F.embedding(as_dtensor(tokens, mesh), table)
    # rows summed over 'model': Partial there until the reduction below
    out_pl = list(tok_pl)
    out_pl[md] = Partial()
    table_pl = [Replicate()] * mesh.ndim
    table_pl[md] = Shard(0)

    def local(table_shard, tok):
        rows = table_shard.shape[0]
        lo = mesh.get_local_rank(md) * rows
        idx = tok - lo
        ok = (idx >= 0) & (idx < rows)
        vals = F.embedding(idx.clamp(0, rows - 1), table_shard)
        return vals * ok[..., None].to(vals.dtype)

    fn = local_map(local, out_placements=out_pl,
                   in_placements=(table_pl, tok_pl),
                   in_grad_placements=(_grad_placements(table_pl, tok_pl),
                                       tok_pl),
                   device_mesh=mesh, redistribute_inputs=True)
    out = fn(table, as_dtensor(tokens, mesh))
    full_pl = list(tok_pl)
    full_pl[md] = Replicate()
    return out.redistribute(mesh, full_pl)
