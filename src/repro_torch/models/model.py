"""Model assembly: the decoder-only LM of the `dense` family with GQA, the
`ssm` family (Mamba2) and the `hybrid` family (Zamba2: Mamba2 layers with
one shared GQA block after every `shared_attn_every` of them).

The port of the JAX package's `models/model.py` for those families.
Parameters live in a `Model` (`nn.Module`) whose attribute names are the
reference's param-tree keys; the reference's stacked `layers` axis becomes
an `nn.ModuleList`, so `state_dict()` keys read `layers.<i>.attn.wq` or
`layers.<i>.ssm.in_proj` (`convert.py` loads the reference's tree into
it).  The other families (`moe`, `vlm`, `encdec`) and MLA raise
`NotImplementedError` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import as_device
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import Norm, ParamInit, dt, embedding_lookup, norm


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not have yet (never a silent path)."""
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP queue 1, item 7)")
    if cfg.family != "ssm" and (cfg.attn != "gqa" or cfg.rope == "mrope"):
        raise NotImplementedError(
            f"{cfg.name}: attn={cfg.attn!r} rope={cfg.rope!r} is not ported "
            f"yet (MLA and M-RoPE: ROADMAP queue 1, item 7)")


# ==========================================================================
# init
# ==========================================================================
class Block(nn.Module):
    """One pre-norm attention block: `ln1`, `attn`, `ln2`, `mlp`."""

    def __init__(self, init: ParamInit, cfg: ModelConfig, d_ff: int):
        super().__init__()
        self.ln1 = Norm(init, cfg.d_model, cfg.norm)
        self.attn = attn.init_gqa(init, cfg)
        self.ln2 = Norm(init, cfg.d_model, cfg.norm)
        self.mlp = moe_mod.init_dense_mlp(init, cfg, d_ff)


class MambaBlock(nn.Module):
    """One pre-norm Mamba2 block: `ln1`, `ssm`."""

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.ln1 = Norm(init, cfg.d_model, cfg.norm)
        self.ssm = ssm_mod.init_mamba2(init, cfg)


class Model(nn.Module):
    """`embed` [V, d], `lm_head` [d, V] (untied only), `ln_f`,
    `dense_layers` (when `first_dense_layers`), `layers` (`Block`s, or
    `MambaBlock`s for the ssm and hybrid families) and `shared_block` (a
    `Block`, hybrid only)."""

    def __init__(self, cfg: ModelConfig, init: ParamInit):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = init.dense(cfg.vocab, cfg.d_model, scale=0.02)
        if not cfg.tie_embeddings:
            self.lm_head = init.dense(cfg.d_model, cfg.vocab, scale=0.02)
        self.ln_f = Norm(init, cfg.d_model, cfg.norm)
        if cfg.family in ("ssm", "hybrid"):
            self.layers = nn.ModuleList(MambaBlock(init, cfg)
                                        for _ in range(cfg.n_layers))
            if cfg.family == "hybrid":
                self.shared_block = Block(init, cfg, cfg.d_ff)
            return
        n_dense = cfg.first_dense_layers
        if n_dense:
            self.dense_layers = nn.ModuleList(
                Block(init, cfg, cfg.d_ff_dense or cfg.d_ff)
                for _ in range(n_dense))
        self.layers = nn.ModuleList(Block(init, cfg, cfg.d_ff)
                                    for _ in range(cfg.n_layers - n_dense))

    def head(self, dtype: torch.dtype) -> torch.Tensor:
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return w.to(dtype)


def init_model(cfg: ModelConfig, generator: torch.Generator = None, *,
               device="cuda") -> Model:
    """-> the model's parameters, drawn from `generator` (a CPU generator
    seeded with 0 when none is given) and placed on `device` in
    `cfg.param_dtype`.  The reference returns (params, specs); the specs
    belong to the parallel slice, which is not ported yet."""
    dev = as_device(device)
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    return Model(cfg, ParamInit(gen, dt(cfg.param_dtype), dev))


# ==========================================================================
# forward (train / prefill)
# ==========================================================================
def _attn_block_fwd(p: Block, cfg: ModelConfig, x, positions, *, causal=True,
                    window=0):
    h = norm(x, p.ln1, cfg.norm, cfg.norm_eps)
    x = x + attn.gqa_forward(p.attn, cfg, h, positions, causal=causal,
                             window=window)
    h = norm(x, p.ln2, cfg.norm, cfg.norm_eps)
    return x + moe_mod.dense_mlp(p.mlp, cfg, h)


def _mamba_block_fwd(p: MambaBlock, cfg: ModelConfig, x):
    h = norm(x, p.ln1, cfg.norm, cfg.norm_eps)
    return x + ssm_mod.mamba2_forward(p.ssm, cfg, h)


def forward(params: Model, cfg: ModelConfig, batch: Dict[str, Any], *,
            remat: str = "dots_no_batch", logits_mode: str = "all"):
    """batch["tokens"] [B, S] -> logits [B, S, V] (logits_mode="last":
    [B, 1, V], the serving prefill's; "hidden": the final normed states).

    `remat` is the reference's training-memory option; it is accepted and
    ignored until training is ported.  Runs under the caller's grad mode;
    the flash and SSD kernels have no backward yet, so serve them under
    `no_grad`."""
    check_supported(cfg)
    cdt = dt(cfg.compute_dtype)
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device)
    b, s = tokens.shape
    x = embedding_lookup(params.embed, tokens).to(cdt)
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    if cfg.family == "ssm":
        for blk in params.layers:
            x = _mamba_block_fwd(blk, cfg, x)
    elif cfg.family == "hybrid":
        k = cfg.shared_attn_every
        for gi in range(cfg.n_layers // k):
            for blk in params.layers[gi * k:(gi + 1) * k]:
                x = _mamba_block_fwd(blk, cfg, x)
            x = _attn_block_fwd(params.shared_block, cfg, x, positions,
                                window=cfg.sliding_window)
    else:
        if cfg.first_dense_layers:
            cfg_dense = dataclasses.replace(cfg,
                                            d_ff=cfg.d_ff_dense or cfg.d_ff)
            for blk in params.dense_layers:
                x = _attn_block_fwd(blk, cfg_dense, x, positions)
        for blk in params.layers:
            x = _attn_block_fwd(blk, cfg, x, positions,
                                window=cfg.sliding_window)
    x = norm(x, params.ln_f, cfg.norm, cfg.norm_eps)
    if logits_mode == "hidden":
        return x
    if logits_mode == "last":
        x = x[:, -1:]
    return torch.einsum("bsd,dv->bsv", x, params.head(cdt))


# ==========================================================================
# decode (single-token serve step against a cache)
# ==========================================================================
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Stacked per-layer caches for decode: k/v [L, B, max_len, Hkv, hd];
    for the ssm and hybrid families `layers` holds conv [L, B, K-1,
    conv_dim] (compute dtype) and ssm [L, B, H, N, P] (float32), and the
    hybrid's `shared` k/v [n_groups, B, max_len, Hkv, hd]."""
    dev = as_device(device)
    check_supported(cfg)
    cdt = dt(cfg.compute_dtype)

    def stack(make, n):
        return {k: v[None].repeat((n,) + (1,) * v.dim())
                for k, v in make().items()}

    def gqa():
        return attn.gqa_init_cache(cfg, batch, max_len, cdt, dev)

    if cfg.family in ("ssm", "hybrid"):
        cache = {"layers": stack(lambda: ssm_mod.mamba2_init_state(
            cfg, batch, cdt, dev), cfg.n_layers)}
        if cfg.family == "hybrid":
            cache["shared"] = stack(gqa, cfg.n_layers // cfg.shared_attn_every)
        return cache
    cache = {"layers": stack(gqa, cfg.n_layers - cfg.first_dense_layers)}
    if cfg.first_dense_layers:
        cache["dense_layers"] = stack(gqa, cfg.first_dense_layers)
    return cache


def _attn_block_decode(p: Block, cfg: ModelConfig, x, cache, pos):
    h = norm(x, p.ln1, cfg.norm, cfg.norm_eps)
    a, cache = attn.gqa_decode(p.attn, cfg, h, cache, pos,
                               window=cfg.sliding_window)
    x = x + a
    h = norm(x, p.ln2, cfg.norm, cfg.norm_eps)
    return x + moe_mod.dense_mlp(p.mlp, cfg, h), cache


def _ssm_block_decode(p: MambaBlock, cfg: ModelConfig, x, state):
    h = norm(x, p.ln1, cfg.norm, cfg.norm_eps)
    y, state = ssm_mod.mamba2_decode(p.ssm, cfg, h, state)
    return x + y, state


@torch.no_grad()
def decode_step(params: Model, cfg: ModelConfig, cache, token, pos: int, *,
                mla_absorb: bool = False):
    """token: [B] int; pos: current cache length.  -> (logits [B, V],
    cache).  The cache is updated in place (`attention.gqa_decode`,
    `ssm.mamba2_decode`) and returned; `mla_absorb` only matters for MLA,
    which is not ported."""
    check_supported(cfg)
    cdt = dt(cfg.compute_dtype)
    token = torch.as_tensor(token, device=params.embed.device)
    x = embedding_lookup(params.embed, token)[:, None, :].to(cdt)

    def layer(stacked, i):
        return {k: v[i] for k, v in stacked.items()}

    def run(blocks, stacked, cfg_b, x):
        for i, blk in enumerate(blocks):
            x, _ = _attn_block_decode(blk, cfg_b, x, layer(stacked, i), pos)
        return x

    def run_ssm(blocks, first, x):
        for i, blk in enumerate(blocks, first):
            x, _ = _ssm_block_decode(blk, cfg, x, layer(cache["layers"], i))
        return x

    if cfg.family == "ssm":
        x = run_ssm(params.layers, 0, x)
    elif cfg.family == "hybrid":
        k = cfg.shared_attn_every
        for gi in range(cfg.n_layers // k):
            x = run_ssm(params.layers[gi * k:(gi + 1) * k], gi * k, x)
            x, _ = _attn_block_decode(params.shared_block, cfg, x,
                                      layer(cache["shared"], gi), pos)
    else:
        if cfg.first_dense_layers:
            cfg_d = dataclasses.replace(cfg, d_ff=cfg.d_ff_dense or cfg.d_ff)
            x = run(params.dense_layers, cache["dense_layers"], cfg_d, x)
        x = run(params.layers, cache["layers"], cfg, x)
    x = norm(x, params.ln_f, cfg.norm, cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, params.head(cdt))[:, 0]
    return logits, cache
