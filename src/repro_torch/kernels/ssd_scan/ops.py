"""Public SSD-scan op on the model's layout: xh [B,T,H,P], dt [B,T,H],
a [H], bh/ch [B,T,G,N] -> y [B,T,H,P] (no D skip term).

A CPU tensor gets the plain PyTorch version (`ref.ssd_chunk_scan_streaming`,
the model's form), chosen by the tensors' device only; a CUDA tensor gets
the kernel (`kernel.py`) or an error, never the plain version.  Unlike the
reference's wrapper, no repeat of B/C to H heads, no dA tensor and no
transpose to [B*H, T, .] is made: the kernel reads the layout as it is.
"""
from __future__ import annotations

from . import kernel
from .ref import ssd_chunk_scan_streaming


def ssd_scan(xh, dt, a, bh, ch, *, chunk: int = 128):
    """xh: [B,T,H,P]; dt: [B,T,H]; a: [H]; bh/ch: [B,T,G,N] -> [B,T,H,P]."""
    kernel.check_inputs(xh, dt, a, bh, ch, chunk=chunk)
    if xh.device.type == "cpu":
        return ssd_chunk_scan_streaming(xh, dt, a, bh, ch, chunk)
    return kernel.ssd_scan_fwd(xh, dt, a, bh, ch, chunk=chunk)
