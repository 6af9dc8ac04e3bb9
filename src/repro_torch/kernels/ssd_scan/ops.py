"""Public SSD-scan op on the model's layout: xh [B,T,H,P], dt [B,T,H],
a [H], bh/ch [B,T,G,N] -> y [B,T,H,P] (no D skip term).

A CPU tensor gets the plain PyTorch version (`ref.ssd_chunk_scan_streaming`,
the model's form), chosen by the tensors' device only (a meta tensor too:
the dry-run's shapes); a CUDA tensor gets the kernel (`kernel.py`) or an
error, never the plain version.  Unlike the reference's wrapper, no repeat of B/C to H heads, no dA tensor and no
transpose to [B*H, T, .] is made: the kernel reads the layout as it is.
DTensor inputs run per rank on their local shards
(`parallel/local_shards.py`):
batch and head shards stay (the groups are sharded alike, or broadcast
when there is one), any other shard is redistributed to replicated first.
"""
from __future__ import annotations

import functools

from torch.distributed.tensor import DTensor

from ...parallel import local_shards
from . import kernel
from .ref import ssd_chunk_scan_streaming


def ssd_scan(xh, dt, a, bh, ch, *, chunk: int = 128):
    """xh: [B,T,H,P]; dt: [B,T,H]; a: [H]; bh/ch: [B,T,G,N] -> [B,T,H,P]."""
    if isinstance(xh, DTensor):
        return _on_local_shards(xh, dt, a, bh, ch, chunk)
    kernel.check_inputs(xh, dt, a, bh, ch, chunk=chunk)
    if xh.device.type in ("cpu", "meta"):
        return ssd_chunk_scan_streaming(xh, dt, a, bh, ch, chunk)
    return kernel.ssd_scan_fwd(xh, dt, a, bh, ch, chunk=chunk)


def _on_local_shards(xh, dt, a, bh, ch, chunk: int):
    mesh = xh.device_mesh
    g = bh.shape[2]
    keep = local_shards.head_parallel(xh, 2, (g,))
    group_dims = {0: 0, 2: 2} if g > 1 else {0: 0}
    pls = [local_shards.placements_for(xh, keep, dims) for dims in
           ({0: 0, 2: 2}, {0: 0, 2: 2}, {2: 0}, group_dims, group_dims)]
    args = [xh] + [local_shards.as_dtensor(t, mesh)
                   for t in (dt, a, bh, ch)]
    return local_shards.run_local(
        functools.partial(ssd_scan, chunk=chunk), args, pls, pls[0], mesh)
