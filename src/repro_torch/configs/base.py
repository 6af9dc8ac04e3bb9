"""Model configuration schema for the assigned architecture pool.

A framework-free copy of the JAX package's `configs/base.py`: the port
imports nothing of that package, so it keeps its own."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    attn: str = "gqa"                # gqa | mla | none
    rope: str = "rope"               # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    sliding_window: int = 0          # 0 = full attention
    # mlp
    d_ff: int = 0
    act: str = "swiglu"              # swiglu | gelu | relu2
    # MLA (DeepSeek-V2 / MiniCPM3)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0
    first_dense_layers: int = 0      # leading dense layers (DeepSeek: 1)
    d_ff_dense: int = 0              # d_ff of those dense layers
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    d_state: int = 0
    ssm_heads: int = 0
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    d_conv: int = 4
    expand: int = 2
    chunk: int = 128
    # hybrid (Zamba2): shared attention block applied every k SSM layers
    shared_attn_every: int = 0
    # encoder-decoder (Whisper)
    enc_layers: int = 0
    dec_layers: int = 0
    # numerics
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # which shapes cannot run (sheet rules); recorded, not silently skipped
    skip_shapes: Tuple[str, ...] = ()

    @property
    def d_inner(self) -> int:        # SSM inner width
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or (self.d_inner // self.ssm_headdim)

    @property
    def d_head(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks)."""
        d = self.d_model
        total = self.vocab * d                      # embed
        if not self.tie_embeddings:
            total += self.vocab * d
        def attn_params():
            if self.attn == "mla":
                p = d * (self.kv_lora_rank + self.qk_rope_dim)
                p += self.kv_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.v_head_dim)
                if self.q_lora_rank:
                    p += d * self.q_lora_rank + self.q_lora_rank * \
                        self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                else:
                    p += d * self.n_heads * (self.qk_nope_dim
                                             + self.qk_rope_dim)
                p += self.n_heads * self.v_head_dim * d
                return p
            hd = self.d_head
            return d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d
        def mlp_params(ff):
            mult = 3 if self.act == "swiglu" else 2
            return mult * d * ff
        def ssm_params():
            di, ns, nh = self.d_inner, self.d_state, self.n_ssm_heads
            g = self.ssm_ngroups
            p = d * (2 * di + 2 * g * ns + nh)      # in_proj (x,z,B,C,dt)
            p += self.d_conv * (di + 2 * g * ns)    # conv
            p += nh * 2                             # A, D
            p += di * d                             # out_proj
            return p
        if self.family == "ssm":
            total += self.n_layers * ssm_params()
        elif self.family == "hybrid":
            total += self.n_layers * ssm_params()
            total += attn_params() + mlp_params(self.d_ff)  # shared block
        elif self.family == "moe":
            dense = self.first_dense_layers
            moe_layers = self.n_layers - dense
            per = attn_params()
            per += (self.n_experts + self.n_shared_experts) \
                * mlp_params(self.d_expert) / 1  # experts
            per += self.d_model * self.n_experts  # router
            total += moe_layers * per
            total += dense * (attn_params() + mlp_params(self.d_ff_dense
                                                         or self.d_ff))
        elif self.family == "encdec":
            enc = self.enc_layers * (attn_params() + mlp_params(self.d_ff))
            dec = self.dec_layers * (2 * attn_params()
                                     + mlp_params(self.d_ff))
            total += enc + dec
        else:
            total += self.n_layers * (attn_params() + mlp_params(self.d_ff))
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        mult = 3 if self.act == "swiglu" else 2
        per_expert = mult * d * self.d_expert
        moe_layers = self.n_layers - self.first_dense_layers
        inactive = moe_layers * (self.n_experts - self.top_k) * per_expert
        return int(full - inactive)
