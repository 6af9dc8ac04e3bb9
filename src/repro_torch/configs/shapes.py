"""Assigned input-shape sets (LM-family: seq_len x global_batch).

`train_*` lowers train_step; `decode_*` / `long_*` lower serve_step (one new
token against a KV cache of seq_len); `prefill_*` lowers the prefill step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cells(arch_cfg) -> Tuple[Tuple[str, ShapeSpec], ...]:
    """(shape_name, spec) pairs applicable to `arch_cfg` (skips recorded)."""
    out = []
    for name, spec in SHAPES.items():
        out.append((name, spec))
    return tuple(out)


def is_skipped(arch_cfg, shape_name: str) -> bool:
    return shape_name in arch_cfg.skip_shapes
