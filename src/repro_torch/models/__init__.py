"""The LM model substrate: the `dense` family with GQA, the `ssm` family
(Mamba2) and the `hybrid` family (Zamba2) (see `model.py`)."""
from .model import (Block, MambaBlock, Model, decode_step, forward,
                    init_cache, init_model)
from .ssm import Mamba2

__all__ = ["Block", "MambaBlock", "Mamba2", "Model", "decode_step",
           "forward", "init_cache", "init_model"]
