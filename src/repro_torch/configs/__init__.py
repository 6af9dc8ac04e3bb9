"""Model configurations: copies of the JAX package's `configs/` (the
schema, the ten registered architectures with their reduced variants, and
the input-shape sets)."""
from .base import ModelConfig
from .registry import ARCHS, get_config, reduced_config
from .shapes import SHAPES, ShapeSpec, is_skipped

__all__ = ["ModelConfig", "ARCHS", "get_config", "reduced_config",
           "SHAPES", "ShapeSpec", "is_skipped"]
