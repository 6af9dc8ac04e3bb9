"""Public op for Mamba2's gate chain on the model's layout: the SSD scan's
output y [B, T, H, P] and its input xh [B, T, H, P] (float32, a view of
the conv's output), D [H], in_proj's z columns [B, T, H P] and out_norm
[H P] -> rms_norm((y + xh D) in `dtype` * silu(z), out_norm, eps), a new
[B, T, H P] tensor of `dtype`.

While autograd records a gradient through any input, the op returns the
plain PyTorch version (`ref.gate_chain`, differentiable) on the tensors as
given, whatever their device: the kernel has no backward
(`kernels/build.py::needs_grad`, the rule every Mamba2 op follows).
Otherwise a CPU or meta tensor gets the plain version, chosen by the
tensor's device only; a CUDA tensor gets the kernel (`kernel.py`) or an
error, never the plain version.  A DTensor runs per rank on its local
shards (`parallel/local_shards.py`), each taking the path its device
names: a batch shard of y stays, and any other shard
(heads or channels, over which the RMS norm reduces) is redistributed to
replicated first, as are D and out_norm.
"""
from __future__ import annotations

import functools

from torch.distributed.tensor import DTensor

from ...parallel import local_shards
from ..build import needs_grad
from . import kernel
from .ref import gate_chain


def ssm_gate(y, xh, D, z, out_norm, *, eps: float, dtype):
    """-> the gated, normalised [B, T, H P] as the module says."""
    if needs_grad(y, xh, D, z, out_norm):
        return gate_chain(y, xh, D, z, out_norm, eps, dtype)
    if isinstance(y, DTensor):
        return _on_local_shards(y, xh, D, z, out_norm, eps, dtype)
    if y.device.type in ("cpu", "meta"):
        return gate_chain(y, xh, D, z, out_norm, eps, dtype)
    return kernel.ssm_gate_fwd(y, xh, D, z, out_norm, eps=eps, dtype=dtype)


def _on_local_shards(y, xh, D, z, out_norm, eps, dtype):
    mesh = y.device_mesh
    keep = [p.is_shard(0) for p in y.placements]
    pl = local_shards.placements_for(y, keep, {0: 0})
    whole = local_shards.placements_for(y, [False] * mesh.ndim, {})
    args = [y] + [local_shards.as_dtensor(t, mesh)
                  for t in (xh, D, z, out_norm)]
    return local_shards.run_local(
        functools.partial(ssm_gate, eps=eps, dtype=dtype), args,
        (pl, pl, whole, pl, whole), pl, mesh)
