"""Public flash-attention op on the model's [B,S,H,D] GQA layout.

A CPU tensor gets the plain PyTorch version (`ref.py`), chosen by the
tensors' device only; a CUDA tensor gets the kernel (`kernel.py`) or an
error, never the plain version.  Unlike the reference's wrapper, no K/V
head expansion or transpose is made: the kernel reads the layout as it is.
"""
from __future__ import annotations

from . import kernel
from .ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True):
    """q: [B,S,H,D]; k/v: [B,S,Hkv,D] -> [B,S,H,D]."""
    kernel.check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    return kernel.flash_attention_fwd(q, k, v, causal=causal)


def _impl(q, k, v):
    return flash_attention(q, k, v, causal=True)


def install():
    """Register as the model's fused attention impl
    (`models/attention.py::set_flash_impl`); `set_flash_impl(None)`
    removes it."""
    from ...models.attention import set_flash_impl
    set_flash_impl(_impl)
