"""Public op for the RMS norm over x's last dim, scaled by weight [d]:
the residual stream's norms and the final norm of every family, and MLA's
latent norms.

While autograd records a gradient through x or the weight, the op returns
the plain PyTorch version (`ref.rms_norm`, differentiable) on the tensors
as given, whatever their device: the kernel has no backward
(`kernels/build.py::needs_grad`, the rule the Mamba2 ops follow).
Otherwise a CPU or meta tensor gets the plain version, chosen by the
tensor's device only; a CUDA tensor gets the kernel (`kernel.py`) or an
error, never the plain version.  A DTensor runs per rank on its local
shards (`parallel/local_shards.py`), each taking the path its device
names: batch and sequence shards of x stay, a shard of the normed dim is
redistributed to replicated first, as is the weight.
"""
from __future__ import annotations

import functools

from torch.distributed.tensor import DTensor, Replicate, Shard

from ...parallel import local_shards
from ..build import needs_grad
from . import kernel, ref


def rms_norm(x, weight, eps: float):
    """-> x normed over its last dim, of x's type and shape."""
    if needs_grad(x, weight):
        return ref.rms_norm(x, weight, eps)
    if isinstance(x, DTensor):
        return _on_local_shards(x, weight, eps)
    if x.device.type in ("cpu", "meta"):
        return ref.rms_norm(x, weight, eps)
    return kernel.rms_norm_fwd(x, weight, eps=eps)


def _on_local_shards(x, weight, eps):
    mesh, last = x.device_mesh, x.dim() - 1
    pl = [Shard(p.dim % x.dim()) if p.is_shard() and p.dim % x.dim() != last
          else Replicate() for p in x.placements]
    whole = [Replicate()] * mesh.ndim
    return local_shards.run_local(
        functools.partial(rms_norm, eps=eps),
        [x, local_shards.as_dtensor(weight, mesh)], (pl, whole), pl, mesh)
