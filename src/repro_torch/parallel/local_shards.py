"""Kernels on DTensor inputs: each rank launches on its local shards
through `torch.distributed.tensor.experimental.local_map`.

The kernels read raw device pointers, so they never take a DTensor
itself.  A sharded batch dim, or a sharded head dim whose companion
inputs can be sharded alike (K/V heads, SSD groups), stays sharded: each
rank's slice is a whole attention/scan problem.  Any other sharded dim (a
sequence dim that the `seq` rule put over `model`, a head dim whose
companions do not divide) is first redistributed to `Replicate`: that is
where SPMD would insert its all-gather.  Nothing is converted to a full
tensor.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Sequence

from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


def as_dtensor(t, mesh) -> DTensor:
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def head_parallel(x: DTensor, head_dim: int, companions: Sequence[int]
                  ) -> List[bool]:
    """For each mesh dim of `x`: may `x` stay sharded there?  Yes for a
    batch shard (dim 0), and for a shard of `head_dim` when every
    companion head count (K/V heads, groups; 1 means broadcast, never
    sharded) divides the shards' product so far."""
    out, factor = [], 1
    for i, p in enumerate(x.placements):
        n = x.device_mesh.size(i)
        if p.is_shard(0):
            out.append(True)
        elif p.is_shard(head_dim) and all(
                c == 1 or c % (factor * n) == 0 for c in companions):
            factor *= n
            out.append(True)
        else:
            out.append(False)
    return out


def placements_for(x: DTensor, keep: Sequence[bool], dims: dict) -> list:
    """Placements of one input: `dims` maps a dim of `x` to this input's
    dim (None: the input has no such dim, or is broadcast along it)."""
    pl = []
    for p, k in zip(x.placements, keep):
        d = dims.get(p.dim) if (k and p.is_shard()) else None
        pl.append(Shard(d) if d is not None else Replicate())
    return pl


def run_local(fn: Callable, args, in_pl, out_pl, mesh):
    """`fn` on each rank's local shards of `args` redistributed to
    `in_pl`; the result is a DTensor of `out_pl`."""
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def attention_on_local_shards(fn: Callable, q: DTensor, k, v, **kw):
    """`fn(q, k, v, **kw)` ([B, S, H, D] attention, K/V heads dividing
    H) per rank on local shards: batch and head shards of `q` stay, K/V
    sharded alike; the result is placed as `q`'s kept shards."""
    mesh = q.device_mesh
    keep = head_parallel(q, 2, (k.shape[2],))
    pl = placements_for(q, keep, {0: 0, 2: 2})
    return run_local(functools.partial(fn, **kw),
                     [q] + [as_dtensor(t, mesh) for t in (k, v)],
                     (pl, pl, pl), pl, mesh)
