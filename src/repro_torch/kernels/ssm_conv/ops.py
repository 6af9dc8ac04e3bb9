"""Public op for Mamba2's conv chain on the model's layout: in_proj's output
zxbcdt [B, T, 2 di + 2 G N + H], conv_w [K, C], conv_b [C], dt_bias [H]
-> (z, conv32, dt): z [B, T, di] the gate's input, a view of zxbcdt;
conv32 [B, T, C] float32, C = di + 2 G N, the SiLU of the causal conv of
x, B and C; dt [B, T, H] float32.

While autograd records a gradient through any input, the op returns the
plain PyTorch version (`ref.conv_chain`, differentiable) on the tensors as
given, whatever their device: the kernel has no backward
(`kernels/build.py::needs_grad`, the rule every Mamba2 op follows).
Otherwise a CPU or meta tensor gets the plain version, chosen by the
tensor's device only; a CUDA tensor gets the kernel (`kernel.py`) or an
error, never the plain version.  A DTensor runs per rank on its local
shards (`parallel/local_shards.py`), each taking the path its device
names: a batch shard stays, and any other shard of zxbcdt
(its last dim, which interleaves z, x, B, C and dt) is redistributed to
replicated first, as are conv_w, conv_b and dt_bias.
"""
from __future__ import annotations

import functools

from torch.distributed.tensor import DTensor

from ...parallel import local_shards
from ..build import needs_grad
from . import kernel
from .ref import conv_chain


def ssm_conv(zxbcdt, conv_w, conv_b, dt_bias, *, d_inner: int, gn: int):
    """-> (z, conv32, dt) as the module says."""
    if needs_grad(zxbcdt, conv_w, conv_b, dt_bias):
        return conv_chain(zxbcdt, conv_w, conv_b, dt_bias, d_inner, gn)
    if isinstance(zxbcdt, DTensor):
        return _on_local_shards(zxbcdt, conv_w, conv_b, dt_bias, d_inner, gn)
    if zxbcdt.device.type in ("cpu", "meta"):
        return conv_chain(zxbcdt, conv_w, conv_b, dt_bias, d_inner, gn)
    conv32, dt = kernel.ssm_conv_fwd(zxbcdt, conv_w, conv_b, dt_bias,
                                     d_inner=d_inner, gn=gn)
    return zxbcdt[..., :d_inner], conv32, dt


def _on_local_shards(zxbcdt, conv_w, conv_b, dt_bias, d_inner, gn):
    mesh = zxbcdt.device_mesh
    keep = [p.is_shard(0) for p in zxbcdt.placements]
    pl = local_shards.placements_for(zxbcdt, keep, {0: 0})
    whole = local_shards.placements_for(zxbcdt, [False] * mesh.ndim, {})
    args = [zxbcdt] + [local_shards.as_dtensor(t, mesh)
                       for t in (conv_w, conv_b, dt_bias)]
    return local_shards.run_local(
        functools.partial(ssm_conv, d_inner=d_inner, gn=gn), args,
        (pl, whole, whole, whole), (pl, pl, pl), mesh)
