"""The benchmark's yardstick of work: operations and bytes counted from a
call's shapes, and the chip's published peaks.  Counted here, from the
configuration file's sizes, so that a share reads the same work whatever
implements it.

This file holds the kernels' counts (frozen copies of `chip_smoke.py`'s
`flash_bound_ms` and `ssd_bound_ms`) and the peaks.  The work of one call
of a model family is counted in `roofline/<reference>.py`, named as the
configuration's plain reference: `work(model, batch, seq)` -> {"flops":
the model's operations, "flash": the shapes of its attention layers,
"ssd": the shapes of its SSD scans}.  A multiply-add is two operations.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_TF32_FLOP_PER_S = 495e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, flop_per_s: float):
    """-> (the least seconds the chip could take, "operations" or "bytes"):
    the larger of the operations at `flop_per_s` and the bytes at HBM
    bandwidth."""
    t_ops, t_bytes = flops / flop_per_s, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_work(b: int, s: int, h: int, hkv: int, d: int, esize: int = 2,
               causal: bool = True):
    """-> (operations, bytes) of attention over q [B, S, H, D] and k/v
    [B, S, Hkv, D]: two products of 2 D operations per (row, visible key)
    pair, S (S + 1) / 2 pairs a head when causal; q, k and v read once and
    o written once at `esize` bytes an element."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs
    nbytes = 2 * b * s * (h + hkv) * d * esize
    return flops, nbytes


def flash_bound_s(b, s, h, hkv, d):
    """The least time of bf16 causal attention on these shapes, at the
    bf16 tensor-core peak."""
    return bound_s(*flash_work(b, s, h, hkv, d, esize=2),
                   PEAK_BF16_FLOP_PER_S)


def ssd_work(b: int, t: int, h: int, p: int, g: int, n: int, q: int):
    """-> (operations, bytes) of the chunked SSD scan: per (batch row,
    chunk of Q) C B^T once a group over the causal Q (Q + 1) / 2 pairs (N
    deep), its weights times X per head (P wide, the same pairs), C times
    the entering state and each chunk's state update (Q x N x P each) per
    head; x, dt, a, B and C read once and y written once, float32."""
    nc, pairs = t // q, q * (q + 1) // 2
    flops = 2 * b * nc * (g * pairs * n + h * pairs * p + 2 * h * q * n * p)
    nbytes = 4 * (2 * b * t * h * p + 2 * b * t * g * n + b * t * h + h)
    return flops, nbytes


def ssd_bound_s(b, t, h, p, g, n, q):
    """The least time of the float32 SSD scan on these shapes: each product
    once at the TF32 tensor-core peak (the fastest rate that keeps float32's
    range), or its bytes, whichever is larger."""
    return bound_s(*ssd_work(b, t, h, p, g, n, q), PEAK_TF32_FLOP_PER_S)
