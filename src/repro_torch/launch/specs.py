"""Meta-device stand-ins for every model input (the port of the JAX
package's `launch/specs.py`): the shape and dtype of each input, with no
allocation, for the dry-run and the step builders."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec
from ..models.layers import dt
from ..models.model import init_cache


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, spec: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Inputs for the train/prefill step of one (arch x shape) cell."""
    b, s = spec.global_batch, spec.seq_len
    cdt = dt(cfg.compute_dtype)
    if cfg.family == "vlm":
        return {"embeds": _meta((b, s, cfg.d_model), cdt),
                "positions3": _meta((3, b, s), torch.int32),
                "labels": _meta((b, s), torch.int32)}
    if cfg.family == "encdec":
        return {"frames": _meta((b, s, cfg.d_model), cdt),
                "tokens": _meta((b, s), torch.int32)}
    return {"tokens": _meta((b, s), torch.int32)}


def decode_specs(cfg: ModelConfig, spec: ShapeSpec) -> Tuple[Dict, torch.Tensor]:
    """(cache, token) for the serve step: a KV cache of seq_len, built by
    `init_cache` on the meta device."""
    b, s = spec.global_batch, spec.seq_len
    cache = init_cache(cfg, b, s, device="meta")
    return cache, _meta((b,), torch.int32)


def batch_logical_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical axes for each input-batch leaf."""
    if cfg.family == "vlm":
        return {"embeds": ("batch", "seq", "embed"),
                "positions3": (None, "batch", "seq"),
                "labels": ("batch", "seq")}
    if cfg.family == "encdec":
        return {"frames": ("batch", "seq", "embed"),
                "tokens": ("batch", "seq")}
    return {"tokens": ("batch", "seq")}
