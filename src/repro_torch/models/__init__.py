"""The LM model substrate: the `dense` family with GQA (see `model.py`)."""
from .model import Model, decode_step, forward, init_cache, init_model

__all__ = ["Model", "decode_step", "forward", "init_cache", "init_model"]
