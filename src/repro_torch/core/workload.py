"""TRIM intra-layer workloads: the 7-dim loop-nest formalism (paper §3.2).

A workload is the nest

    for n in N:  for m in M:  for c in C:
      for r in R:  for s in S:
        for e in E:  for f in F:
          out[n,e,f,m] += in[n, e*U + r*DR, f*V + s*DS, c] * w[r,s,c,m]

Dims are indexed in the canonical order (N, M, C, R, S, E, F).  We extend the
paper with dilation (DR, DS) so the three training phases (FW/BW/WG) of a conv
are all expressible in the same formalism (paper Eqs. 1-3):

  FW : out = conv(pad(x), w)                      -> stride (U,V), dilation 1
  BW : dx  = conv(pad(upsample(dy)), rot180(w^T)) -> stride 1,    dilation 1
  WG : dw  = conv(pad(x), upsample(dy))           -> stride 1,    dilation (U,V)
       with dims remapped (N_w, M_w, C_w, R_w, S_w, E_w, F_w)
                        = (C,   M,   N,   E',  F',  R,   S)

Tensor relevance (which loop dims index which tensor):
  weights: (M, C, R, S)      outputs: (N, M, E, F)
  inputs : (N, C) + the sliding pairs (E,R) on axis P and (F,S) on axis Q.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

DIMS = ("N", "M", "C", "R", "S", "E", "F")
N_, M_, C_, R_, S_, E_, F_ = range(7)

# Relevance masks over canonical dim order (N, M, C, R, S, E, F).
WEIGHT_RELEVANT = (False, True, True, True, True, False, False)
OUTPUT_RELEVANT = (True, True, False, False, False, True, True)
# For inputs, every dim except M is relevant (E/R and F/S couple on P/Q axes).
INPUT_RELEVANT = (True, False, True, True, True, True, True)

TENSORS = ("input", "weight", "output")
I_T, W_T, O_T = range(3)
RELEVANCE = {"input": INPUT_RELEVANT, "weight": WEIGHT_RELEVANT,
             "output": OUTPUT_RELEVANT}


@dataclasses.dataclass(frozen=True)
class Workload:
    """One intra-layer workload (one phase of one layer)."""

    dims: Tuple[int, int, int, int, int, int, int]  # (N, M, C, R, S, E, F)
    stride: Tuple[int, int] = (1, 1)                # (U, V) on (E, F)
    dilation: Tuple[int, int] = (1, 1)              # (DR, DS) on (R, S)
    kind: str = "mac"                               # mac | pool_max | pool_avg
    # Depthwise ops (pooling, depthwise conv): the C dim indexes the output
    # too (out[n,e,f,c]) and M must be 1.
    depthwise: bool = False
    name: str = ""
    layer: str = ""
    phase: str = "FW"                               # FW | BW | WG
    # Fraction of *predictable* zeros (padding/upsampling) in input and weight
    # operands, used by the zero-skipping energy model (paper §8.2.1).
    input_zero_frac: float = 0.0
    weight_zero_frac: float = 0.0

    def __post_init__(self):
        assert len(self.dims) == 7 and all(d >= 1 for d in self.dims), self.dims
        assert self.kind in ("mac", "pool_max", "pool_avg")
        if self.depthwise:
            assert self.dims[M_] == 1, "depthwise workloads must have M == 1"

    @property
    def has_weight(self) -> bool:
        """Pooling has no weight operand."""
        return self.kind == "mac"

    def relevance(self, tensor: str) -> Tuple[bool, ...]:
        base = RELEVANCE[tensor]
        if self.depthwise and tensor == "output":
            # out[n,e,f,c]: C becomes an output dim as well.
            return (True, True, True, False, False, True, True)
        return base

    # -- derived quantities ------------------------------------------------
    @property
    def bound(self):
        return dict(zip(DIMS, self.dims))

    @property
    def macs(self) -> int:
        return math.prod(self.dims)

    def input_extent(self, e: int, r: int, axis: int) -> int:
        """Input halo extent covered by e outputs and r taps on one axis."""
        u = self.stride[axis]
        d = self.dilation[axis]
        return (e - 1) * u + (r - 1) * d + 1

    @property
    def input_shape(self):  # (N, P, Q, C)
        n, m, c, r, s, e, f = self.dims
        return (n, self.input_extent(e, r, 0), self.input_extent(f, s, 1), c)

    @property
    def weight_shape(self):  # (R, S, C, M)
        n, m, c, r, s, e, f = self.dims
        return (r, s, c, m)

    @property
    def output_shape(self):  # (N, E, F, M) — or (N, E, F, C) if depthwise
        n, m, c, r, s, e, f = self.dims
        return (n, e, f, c if self.depthwise else m)

    def tensor_words(self, tensor: str) -> int:
        if tensor == "weight" and not self.has_weight:
            return 0
        return math.prod({"input": self.input_shape,
                          "weight": self.weight_shape,
                          "output": self.output_shape}[tensor])

    def tile_words(self, tensor: str, tile_dims) -> int:
        """Words of `tensor` covered by a tile with per-dim extents.

        `tile_dims` is a 7-tuple in canonical order (each <= self.dims).
        """
        n, m, c, r, s, e, f = tile_dims
        if tensor == "weight":
            return r * s * c * m if self.has_weight else 0
        if tensor == "output":
            return n * e * f * (c if self.depthwise else m)
        return n * c * self.input_extent(e, r, 0) * self.input_extent(f, s, 1)


def conv2d_workload(*, batch, in_ch, out_ch, out_h, out_w, kr, ks,
                    stride=(1, 1), dilation=(1, 1), name="conv", phase="FW",
                    input_zero_frac=0.0, weight_zero_frac=0.0,
                    kind="mac", layer=None) -> Workload:
    return Workload(dims=(batch, out_ch, in_ch, kr, ks, out_h, out_w),
                    stride=tuple(stride), dilation=tuple(dilation), kind=kind,
                    name=name, layer=layer or name.split(".")[0],
                    phase=phase, input_zero_frac=input_zero_frac,
                    weight_zero_frac=weight_zero_frac)


def matmul_workload(*, rows, cols, inner, name="fc", phase="FW",
                    input_zero_frac=0.0, weight_zero_frac=0.0,
                    layer=None) -> Workload:
    """rows x inner @ inner x cols (paper: R=S=E=F=1)."""
    return Workload(dims=(rows, cols, inner, 1, 1, 1, 1), name=name,
                    layer=layer or name.split(".")[0], phase=phase,
                    input_zero_frac=input_zero_frac,
                    weight_zero_frac=weight_zero_frac)


@dataclasses.dataclass(frozen=True)
class PreprocWorkload:
    """Inter-layer data-preprocessing workload (paper §3.3, Eqs. 1-3)."""

    op: str                 # padding | upsampling | rot180 | im2col
    out_words: int
    zero_frac: float = 0.0  # fraction of output words that are predictable 0s
    name: str = ""
    phase: str = "FW"


@dataclasses.dataclass(frozen=True)
class ActivationCache:
    """Inter-layer intermediate-activation caching workload (paper §3.3).

    The activation produced at `created` (workload index in schedule order)
    stays live until `freed` (exclusive).  Liveness drives both the buffer
    validation adjustment and static (leakage) energy.
    """

    words: int
    created: int
    freed: int
    name: str = ""

    @property
    def live_span(self) -> int:
        return self.freed - self.created
