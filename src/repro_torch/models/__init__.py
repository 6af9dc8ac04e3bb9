"""The LM model substrate: every family of `configs/registry.py` (`dense`,
`moe`, `vlm` with GQA or MLA; `ssm`; `hybrid`; `encdec`) (see
`model.py`)."""
from .attention import MLA, cross_forward, cross_kv, mla_decode, mla_forward
from .model import (CE_CHUNK, REMAT_POLICIES, Block, MambaBlock, Model,
                    cache_specs, decode_step, forward, init_cache, init_model,
                    lm_loss)
from .moe import MoE, aux_load_balance_loss, moe_mlp
from .ssm import Mamba2

__all__ = ["CE_CHUNK", "REMAT_POLICIES", "Block", "MLA", "MambaBlock",
           "Mamba2", "MoE", "Model", "aux_load_balance_loss", "cache_specs",
           "cross_forward", "cross_kv", "decode_step", "forward",
           "init_cache", "init_model", "lm_loss", "mla_decode", "mla_forward",
           "moe_mlp"]
