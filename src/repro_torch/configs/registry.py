"""The 10 assigned architectures (+ reduced variants for smoke tests).

Exact configs from the assignment sheet; sources noted inline.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .base import ModelConfig

# Pure-full-attention archs skip long_500k (sub-quadratic required);
# encoder-only archs would skip decode shapes (none here: whisper is
# enc-dec so its decoder step exists).
FULL_ATTN_SKIPS = ("long_500k",)

ARCHS: Dict[str, ModelConfig] = {}


def _reg(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# [hf:ibm-granite/granite-3.0-1b-a400m-base]
GRANITE_MOE = _reg(ModelConfig(
    name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=8, head_dim=64, d_ff=512, d_expert=512,
    vocab=49155, n_experts=32, top_k=8, act="swiglu",
    skip_shapes=FULL_ATTN_SKIPS))

# [arXiv:2405.04434] DeepSeek-V2-Lite: MLA kv_lora=512, 2 shared + 64
# routed top-6 (assignment sheet also mentions "160 routed" — that is the
# full-V2 number; see DESIGN.md §5).
DEEPSEEK_V2_LITE = _reg(ModelConfig(
    name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, d_expert=1408,
    vocab=102400, attn="mla", kv_lora_rank=512, q_lora_rank=0,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=64, top_k=6, n_shared_experts=2,
    first_dense_layers=1, d_ff_dense=10944, act="swiglu",
    skip_shapes=FULL_ATTN_SKIPS))

# [arXiv:2404.14219]
PHI3_MINI = _reg(ModelConfig(
    name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, head_dim=96, d_ff=8192, vocab=32064,
    act="swiglu", skip_shapes=FULL_ATTN_SKIPS))

# [hf:openbmb/MiniCPM3-4B] MLA
MINICPM3 = _reg(ModelConfig(
    name="minicpm3-4b", family="dense", n_layers=62, d_model=2560,
    n_heads=40, n_kv_heads=40, head_dim=64, d_ff=6400, vocab=73448,
    attn="mla", kv_lora_rank=256, q_lora_rank=768, qk_nope_dim=64,
    qk_rope_dim=32, v_head_dim=64, act="swiglu",
    skip_shapes=FULL_ATTN_SKIPS))

# [arXiv:2402.16819] squared-ReLU, GQA kv=8
NEMOTRON4 = _reg(ModelConfig(
    name="nemotron-4-15b", family="dense", n_layers=32, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=24576, vocab=256000,
    act="relu2", tie_embeddings=False, skip_shapes=FULL_ATTN_SKIPS))

# [hf:HuggingFaceTB/SmolLM-135M]
SMOLLM = _reg(ModelConfig(
    name="smollm-135m", family="dense", n_layers=30, d_model=576,
    n_heads=9, n_kv_heads=3, head_dim=64, d_ff=1536, vocab=49152,
    act="swiglu", skip_shapes=FULL_ATTN_SKIPS))

# [arXiv:2212.04356] enc-dec; conv frontend stubbed (frame embeddings in)
WHISPER_SMALL = _reg(ModelConfig(
    name="whisper-small", family="encdec", n_layers=24, enc_layers=12,
    dec_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab=51865, act="gelu", rope="none", norm="layernorm",
    tie_embeddings=True, skip_shapes=FULL_ATTN_SKIPS))

# [arXiv:2405.21060] SSD; attention-free => runs long_500k
MAMBA2 = _reg(ModelConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280, attn="none", rope="none",
    d_state=128, ssm_headdim=64, expand=2, d_conv=4, chunk=128,
    tie_embeddings=True))

# [arXiv:2409.12191] M-RoPE; patch embeddings stubbed
QWEN2_VL = _reg(ModelConfig(
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, head_dim=128, d_ff=8960, vocab=151936,
    act="swiglu", rope="mrope", mrope_sections=(16, 24, 24),
    skip_shapes=FULL_ATTN_SKIPS))

# [arXiv:2411.15242] Mamba2 + shared attn block every 6 layers; runs
# long_500k with the shared block in sliding-window mode (DESIGN.md §5)
ZAMBA2 = _reg(ModelConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, head_dim=80, d_ff=10240, vocab=32000,
    act="gelu", d_state=64, ssm_headdim=64, expand=2, d_conv=4, chunk=128,
    shared_attn_every=6, sliding_window=4096))


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    cfg = ARCHS[name]
    changes = dict(
        n_layers=min(cfg.n_layers, 2), d_model=64, vocab=128,
        param_dtype="float32", compute_dtype="float32")
    if cfg.n_heads:
        changes.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
                       head_dim=16)
    if cfg.d_ff:
        changes["d_ff"] = 128
    if cfg.attn == "mla":
        changes.update(kv_lora_rank=32,
                       q_lora_rank=32 if cfg.q_lora_rank else 0,
                       qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    if cfg.n_experts:
        changes.update(n_experts=4, top_k=2, d_expert=64,
                       d_ff_dense=128 if cfg.d_ff_dense else 0)
    if cfg.family in ("ssm", "hybrid"):
        changes.update(d_state=16, ssm_headdim=16, chunk=16)
        if cfg.family == "hybrid":
            changes.update(n_layers=4, shared_attn_every=2, n_heads=4,
                           n_kv_heads=4, head_dim=16, d_ff=128,
                           sliding_window=32)
    if cfg.family == "encdec":
        changes.update(enc_layers=2, dec_layers=2, n_layers=4)
    if cfg.rope == "mrope":
        changes.update(mrope_sections=(2, 3, 3))
    return dataclasses.replace(cfg, **changes)
