"""Sharded step builders on DTensor (the port of the JAX package's
`launch/steps.py`, shared by the dry-run, the trainer and the tests).

Each builder returns `(fn, shape_structs, placements)`: the step, the
meta-device stand-ins of its inputs, and the DTensor placements of those
inputs resolved from the logical rules.  A step places what it is handed
(full tensors, the same on every rank, are sliced to the local shard with
no communication), installs the activation-sharding hooks for the length
of the call and clears them in `finally`, and runs the port's own step
functions on DTensors under `implicit_replication` (a plain tensor made
inside the model, such as the positions, counts as replicated).

Parameters are drawn full from the CPU generator on every rank and then
distributed (`init_sharded_params`), so a sharded model starts from the
unsharded one's values.  The optimizer state (`m`, `v`, `master`) is
ZeRO-extended over `data` as the reference's `zero_extend` does, and the
update runs on local shards (`sharded_apply_updates`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec
from ..models import decode_step, forward, init_model
from ..models.layers import LOGICAL_AXES_ATTR, param_specs
from ..models.model import Model, cache_specs
from ..parallel.collectives import compress_grads_inplace
from ..parallel.sharding import (P, PartitionSpec, ShardingRules,
                                 activation_sharding, distribute,
                                 logical_placements, mesh_axis_sizes,
                                 param_shardings, placements)
from ..train.optimizer import (OptConfig, OptState, adamw_update,
                               global_norm)
from ..train.train_step import (TrainConfig, TrainState, _split_microbatches,
                                loss_and_grads)
from .specs import batch_logical_specs, decode_specs, input_specs


def model_shapes(cfg: ModelConfig) -> Tuple[Dict[str, torch.Tensor],
                                             Dict[str, Tuple]]:
    """({name: meta-device parameter}, {name: logical axes}): no
    allocation."""
    model = init_model(cfg, device="meta")
    return dict(model.named_parameters()), param_specs(model)


def zero_extend(pspec: PartitionSpec, shape, mesh) -> PartitionSpec:
    """The optimizer state's spec: the parameter's, plus the first
    still-replicated dim that `data` divides sharded over `data` (fp32
    optimizer state is the largest consumer; expert weights are
    E-sharded only)."""
    spec = list(pspec) + [None] * (len(shape) - len(pspec))
    used = {a for s in spec if s for a in (s if isinstance(s, tuple)
                                           else (s,))}
    sizes = mesh_axis_sizes(mesh)
    if "data" in sizes and "data" not in used:
        dsz = sizes["data"]
        for i, s in enumerate(spec):
            if s is None and shape[i] % dsz == 0 and shape[i] >= dsz:
                spec[i] = "data"
                break
    return P(*spec)


@dataclasses.dataclass
class TrainPlacements:
    """Placements of a sharded train state and batch: `params` (and the
    error-feedback state) by name, `opt` (m, v, master) by name, the
    ZeRO-extended ones, and `batch` by input key."""
    params: Dict[str, list]
    opt: Dict[str, list]
    batch: Dict[str, list]


def _replicated(mesh) -> list:
    return [Replicate()] * mesh.ndim


def place(t, mesh, pl) -> DTensor:
    """A full tensor or host array (the same on every rank) -> a DTensor
    of placements `pl`; a DTensor is redistributed to them."""
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == tuple(pl) \
            else t.redistribute(mesh, pl)
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    if not t.is_meta:
        t = t.to(mesh.device_type)
    return distribute(t, mesh, pl)


def place_tree(tree, pl_tree, mesh):
    """`place` over a nested dict of leaves."""
    if isinstance(tree, Mapping):
        return {k: place_tree(v, pl_tree[k], mesh) for k, v in tree.items()}
    return place(tree, mesh, pl_tree)


def shard_params(model: Model, pl: Mapping[str, list], mesh) -> Model:
    """Replace every parameter of `model` in place by a DTensor parameter
    of its placements (each rank keeps its slice); -> model."""
    for name, p in list(model.named_parameters()):
        mod = model.get_submodule(name.rpartition(".")[0]) if "." in name \
            else model
        leaf = name.rpartition(".")[2]
        new = torch.nn.Parameter(distribute(p.detach(), mesh, pl[name]),
                                 requires_grad=p.requires_grad)
        if hasattr(p, LOGICAL_AXES_ATTR):
            setattr(new, LOGICAL_AXES_ATTR, getattr(p, LOGICAL_AXES_ATTR))
        mod._parameters[leaf] = new
    return model


def param_placements(cfg: ModelConfig, mesh, rules: ShardingRules):
    """-> (meta params by name, {name: PartitionSpec}, {name:
    placements})."""
    shapes, specs = model_shapes(cfg)
    ps = param_shardings(specs, {n: p.shape for n, p in shapes.items()},
                         rules, mesh)
    return shapes, ps, {n: placements(s, mesh) for n, s in ps.items()}


def init_sharded_params(cfg: ModelConfig, mesh, pl: Mapping[str, list], *,
                        device="cuda", generator=None) -> Model:
    """The model drawn full from `generator` (a CPU generator seeded with
    0 by default) on every rank, then sharded by `pl`."""
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    return shard_params(init_model(cfg, gen, device=device), pl, mesh)


def _zeros(mesh, pl, like: DTensor, dtype=torch.float32) -> DTensor:
    full = torch.empty(like.shape, dtype=dtype, device="meta")
    local = distribute(full, mesh, pl).to_local()
    return DTensor.from_local(torch.zeros(local.shape, dtype=dtype,
                                          device=like.to_local().device),
                              mesh, pl, run_check=False, shape=like.shape,
                              stride=full.stride())


def init_sharded_state(params: Model, opt_cfg: OptConfig, tc: TrainConfig,
                       mesh, tp: TrainPlacements) -> TrainState:
    """A `TrainState` over sharded `params`: m and v zeros and the float32
    master in the ZeRO placements, the error-feedback state (with
    gradient compression) zeros in the parameters' placements."""
    named = dict(params.named_parameters())
    m = {n: _zeros(mesh, tp.opt[n], p) for n, p in named.items()}
    v = {n: _zeros(mesh, tp.opt[n], p) for n, p in named.items()}
    master = {n: p.detach().float().redistribute(mesh, tp.opt[n])
              for n, p in named.items()} if opt_cfg.master_fp32 else None
    err = {n: _zeros(mesh, tp.params[n], p) for n, p in named.items()} \
        if tc.grad_compression else None
    return TrainState(params, OptState(step=0, m=m, v=v, master=master), err)


def _mesh_all_reduce(t: torch.Tensor, op) -> torch.Tensor:
    """All-reduce a local tensor over every rank (the mesh is the
    world)."""
    if dist.get_world_size() > 1:
        dist.all_reduce(t, op=op)
    return t


def _replication(t: DTensor) -> int:
    """How many ranks hold each element of `t`."""
    return int(np.prod([t.device_mesh.size(i)
                        for i, p in enumerate(t.placements)
                        if p.is_replicate()]))


@torch.no_grad()
def sharded_apply_updates(cfg: OptConfig, params: Model,
                          grads: Mapping[str, DTensor], state: OptState,
                          tp: TrainPlacements, mesh):
    """`optimizer.apply_updates` on DTensors: the global gradient norm
    from each rank's norm of its local shards (each element counted once,
    by the plain step's `optimizer.global_norm`) and one all-reduce of
    its square; the AdamW arithmetic (`adamw_update`) on the local
    shards of the ZeRO placements; the new float32 values all-gathered
    back to the parameters' placements.  -> metrics {"grad_norm": float32
    tensor, "lr": float}."""
    named = dict(params.named_parameters())
    names = list(named)
    local = [grads[n].to_local() for n in names]
    shares = torch.tensor([float(_replication(grads[n])) for n in names],
                          device=local[0].device)
    # on one rank sqrt(n * n) rounds back to n: the plain step's norm
    gnorm = _mesh_all_reduce(global_norm(local, shares).square(),
                             dist.ReduceOp.SUM).sqrt()
    g32 = [grads[n].float().redistribute(mesh, tp.opt[n]).to_local()
           for n in names]
    if state.master is not None:
        base_dt = [state.master[n] for n in names]
    else:
        base_dt = [named[n].detach().float().redistribute(mesh, tp.opt[n])
                   for n in names]
    base = [b.to_local() for b in base_dt]
    step = state.step + 1
    lr = adamw_update(cfg, g32, [state.m[n].to_local() for n in names],
                      [state.v[n].to_local() for n in names], base, gnorm,
                      step)
    for n, b in zip(names, base_dt):
        new = b.redistribute(mesh, tp.params[n]).to_local()
        named[n].to_local().copy_(new)
    state.step = step
    return {"grad_norm": gnorm, "lr": lr}


def _compress_sharded(grads: Dict[str, DTensor], err: Dict[str, DTensor]):
    """int8 error feedback on the local shards; the scale's amax is
    all-reduced (MAX) over the mesh."""
    local = {n: g.to_local() for n, g in grads.items()}
    err_local = {n: e.to_local() for n, e in err.items()}
    out, _ = compress_grads_inplace(
        local, err_local,
        amax_reduce=lambda a: _mesh_all_reduce(a.clone(), dist.ReduceOp.MAX))
    return {n: DTensor.from_local(out[n], g.device_mesh, g.placements,
                                  run_check=False, shape=g.shape,
                                  stride=g.stride())
            for n, g in grads.items()}


def _batch_placements(cfg, spec, rules, mesh):
    specs = input_specs(cfg, spec)
    blog = batch_logical_specs(cfg)
    return specs, {k: logical_placements(blog[k], v.shape, rules, mesh)
                   for k, v in specs.items()}


def build_train_step(cfg: ModelConfig, mesh, rules: ShardingRules,
                     spec: ShapeSpec, *, opt_cfg: Optional[OptConfig] = None,
                     tc: Optional[TrainConfig] = None):
    """-> (step(state, batch) -> (state, metrics), (param shapes, input
    specs), TrainPlacements).  `batch` holds full tensors or host arrays
    (the same on every rank) or DTensors; with microbatches it is split
    before it is placed, so each microbatch is sharded over the batch
    axes.  Metrics: "loss" and "grad_norm" are float32 tensors whose
    value every rank holds, "lr" a float."""
    opt_cfg = opt_cfg or OptConfig()
    tc = tc or TrainConfig()
    shapes, ps, p_pl = param_placements(cfg, mesh, rules)
    o_pl = {n: placements(zero_extend(ps[n], s.shape, mesh), mesh)
            for n, s in shapes.items()}
    in_specs, b_pl = _batch_placements(cfg, spec, rules, mesh)
    tp = TrainPlacements(params=p_pl, opt=o_pl, batch=b_pl)

    def place_batch(batch):
        return {k: place(v, mesh, b_pl[k]) for k, v in batch.items()}

    def place_grad(name, g):
        return g.redistribute(mesh, p_pl[name])

    def step(state: TrainState, batch):
        if tc.microbatches > 1:
            full = {k: v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in batch.items()}
            placed = [place_batch(mb) for mb in
                      _split_microbatches(full, tc.microbatches)]
        else:
            placed = place_batch(batch)
        with activation_sharding(mesh, rules), implicit_replication():
            loss, grads = loss_and_grads(cfg, tc, state.params, placed,
                                         place_grad=place_grad)
            if tc.grad_compression and state.compress_err is not None:
                grads = _compress_sharded(grads, state.compress_err)
            metrics = sharded_apply_updates(opt_cfg, state.params, grads,
                                            state.opt, tp, mesh)
        metrics["loss"] = loss.redistribute(mesh, _replicated(mesh)) \
            .to_local()
        return state, metrics

    return step, (shapes, in_specs), tp


def build_prefill_step(cfg: ModelConfig, mesh, rules: ShardingRules,
                       spec: ShapeSpec, *, remat: str = "none"):
    """-> (prefill(params, batch) -> last-position logits [B, 1, V] as a
    DTensor, (param shapes, input specs), (param placements, batch
    placements)).  Runs under `no_grad`, so the flash and SSD kernels (when
    installed) launch on each rank's local shards."""
    shapes, _, p_pl = param_placements(cfg, mesh, rules)
    in_specs, b_pl = _batch_placements(cfg, spec, rules, mesh)

    @torch.no_grad()
    def prefill(params: Model, batch):
        placed = {k: place(v, mesh, b_pl[k]) for k, v in batch.items()}
        with activation_sharding(mesh, rules), implicit_replication():
            return forward(params, cfg, placed, remat=remat,
                           logits_mode="last")

    return prefill, (shapes, in_specs), (p_pl, b_pl)


def cache_placements(cfg: ModelConfig, cache, rules, mesh):
    """Placements of a cache tree (as `init_cache` builds it) by
    `cache_specs`."""
    def walk(sp, c):
        if isinstance(c, Mapping):
            return {k: walk(sp[k], v) for k, v in c.items()}
        return logical_placements(sp, c.shape, rules, mesh)
    return walk(cache_specs(cfg), cache)


def build_decode_step(cfg: ModelConfig, mesh, rules: ShardingRules,
                      spec: ShapeSpec, *, mla_absorb: bool = False):
    """-> (serve_step(params, cache, token, pos) -> (logits [B, V] DTensor,
    cache), (param shapes, cache specs, token spec, pos), (param
    placements, cache placements, token placements)).  The cache must be
    placed (`place_tree(cache, cache_pl, mesh)`); it is updated in place
    on the local shards."""
    shapes, _, p_pl = param_placements(cfg, mesh, rules)
    cache_shapes, token_spec = decode_specs(cfg, spec)
    c_pl = cache_placements(cfg, cache_shapes, rules, mesh)
    t_pl = logical_placements(("batch",), token_spec.shape, rules, mesh)

    def serve_step(params: Model, cache, token, pos: int):
        tok = place(token, mesh, t_pl)
        with activation_sharding(mesh, rules), implicit_replication():
            return decode_step(params, cfg, cache, tok, pos,
                               mla_absorb=mla_absorb)

    return serve_step, (shapes, cache_shapes, token_spec, 0), \
        (p_pl, c_pl, t_pl)
