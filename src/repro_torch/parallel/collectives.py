"""Distributed-optimization collectives (the port of the JAX package's
`parallel/collectives.py`).

* int8 gradient compression with error feedback: quantize grads to int8
  with a per-tensor scale before the DP reduction, keep the quantization
  residual locally and add it back next step (1-bit-Adam-style error
  feedback keeps convergence).  On one device nothing is reduced: the
  quantize -> dequantize round trip is what a data-parallel reduction of
  the int8 payload would see.  `torch.round` rounds half to even, as
  `jnp.round` does, so the int8 codes equal the reference's.
* ring-cost model helpers used by the TRIM tpu_adapter.

Nothing here needs a process group.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch

from ..train.optimizer import named_params

# a block of a layer stack: `layers.<i>.`, `dec_layers.<i>.`, ...
_STACKED = re.compile(r"^((?:dense_|enc_|dec_)?layers)\.\d+\.")


def quantize_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 codes, float32 scale []).  The scale is `amax` (default
    max |x|) over 127."""
    if amax is None:
        amax = x.abs().max()
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def scale_groups(names) -> List[List[str]]:
    """Parameter names grouped as the reference's leaves: the blocks of a
    layer stack (`layers.<i>.attn.wq` for every i) form one group, as the
    reference stacks them into one array; every other name is its own."""
    groups: Dict[str, List[str]] = {}
    for name in names:
        groups.setdefault(_STACKED.sub(r"\1.", name), []).append(name)
    return list(groups.values())


def compress_grads_inplace(grads: Dict[str, torch.Tensor],
                           err_state: Dict[str, torch.Tensor],
                           amax_reduce=None):
    """Error-feedback int8 compression of a gradient dict.

    Returns (decompressed grads, error state): each gradient is
    round-tripped through int8 after its residual is added back, with one
    scale per reference leaf (`scale_groups`: a stack's blocks share the
    scale of their stacked array), and the new residual is written into
    `err_state`'s tensors in place (the same dict comes back; the
    reference returns new arrays of equal values).  On one rank's shards,
    `amax_reduce` takes the local max |g| of a group to the global one
    (an all-reduce MAX over the mesh)."""
    out = {}
    for group in scale_groups(grads):
        g32 = {n: grads[n].float() + err_state[n] for n in group}
        amax = torch.stack([g.abs().max() for g in g32.values()]).max()
        if amax_reduce is not None:
            amax = amax_reduce(amax)
        for name, g in g32.items():
            q, scale = quantize_int8(g, amax)
            deq = dequantize_int8(q, scale)
            err_state[name].copy_(g - deq)
            out[name] = deq
    return out, err_state


def init_error_state(params) -> Dict[str, torch.Tensor]:
    """Float32 zeros per parameter of `params` (an `nn.Module` or a
    name -> tensor mapping), on the parameter's device."""
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in named_params(params).items()}


# ---------------------------------------------------------------------------
# Ring collective cost model (used by TRIM tpu_adapter + roofline)
# ---------------------------------------------------------------------------
def all_gather_bytes(shard_bytes: float, k: int) -> float:
    """Ring all-gather: each link carries (k-1)/k of the full tensor."""
    return shard_bytes * (k - 1)


def reduce_scatter_bytes(full_bytes: float, k: int) -> float:
    return full_bytes * (k - 1) / k


def all_reduce_bytes(full_bytes: float, k: int) -> float:
    """reduce-scatter + all-gather."""
    return 2.0 * full_bytes * (k - 1) / k


def all_to_all_bytes(full_bytes: float, k: int) -> float:
    return full_bytes * (k - 1) / k
