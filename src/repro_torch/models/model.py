"""Model assembly for every family of `configs/registry.py`: the
decoder-only LM (`dense`, `moe`, `vlm`; GQA or MLA), the `ssm` family
(Mamba2), the `hybrid` family (Zamba2: Mamba2 layers with one shared GQA
block after every `shared_attn_every` of them) and `encdec` (Whisper: an
encoder, then a decoder with cross-attention).

The port of the JAX package's `models/model.py`.  Parameters live in a
`Model` (`nn.Module`) whose attribute names are the reference's param-tree
keys; the reference's stacked `layers` axes become `nn.ModuleList`s, so
`state_dict()` keys read `layers.<i>.attn.wq` or `dec_layers.<i>.cross.wk`
(`convert.py` loads the reference's tree into it).

Training: `lm_loss` is the next-token cross-entropy, and `remat` recomputes
each layer block in the backward pass (`torch.utils.checkpoint`, the
counterpart of the reference's `jax.checkpoint` around its layer scan).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..configs.base import ModelConfig
from ..device import as_device
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (Norm, ParamInit, dt, embedding_lookup, norm,
                     sinusoidal_positions)

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")
_aten = torch.ops.aten
_MM = (_aten.mm.default, _aten.addmm.default)
_BMM = (_aten.bmm.default, _aten.baddbmm.default)


def _saves_dot(batch_dims: bool):
    """A selective-checkpoint policy that saves the outputs of matrix
    products and recomputes everything else.  `x @ w` of a 3-D x and a
    2-D w lowers to `aten.mm`; every `torch.einsum` lowers to `aten.bmm`,
    one without batch dims (the attention projections "bsd,dhk->bshk")
    as a bmm of batch 1.  With `batch_dims` every product is saved (JAX's
    `checkpoint_dots`); without, only those of no batch dims: mm, addmm,
    and bmm/baddbmm of batch 1 (`checkpoint_dots_with_no_batch_dims`), so
    the batched attention and expert products are recomputed."""
    def policy(ctx, op, *args, **kwargs):
        if op in _MM or (op in _BMM and (batch_dims
                                         or args[0].shape[0] == 1)):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return functools.partial(create_selective_checkpoint_contexts, policy)


# remat mode -> the checkpoint's context factory (None: no checkpoint;
# "full" saves only each block's inputs and recomputes the whole block)
REMAT_POLICIES = {
    "none": None,
    "full": noop_context_fn,
    "dots": _saves_dot(batch_dims=True),
    "dots_no_batch": _saves_dot(batch_dims=False),
}


def _remat(fn, remat: str):
    """`fn` recomputed in the backward pass as `remat` says; as it is
    when `remat` is "none" or no gradient is being recorded."""
    context_fn = REMAT_POLICIES[remat]
    if context_fn is None or not torch.is_grad_enabled():
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=context_fn)


# ==========================================================================
# init
# ==========================================================================
class Block(nn.Module):
    """One pre-norm attention block: `ln1`, `attn` (GQA, or MLA when
    `cfg.attn == "mla"`), `ln_cross` and `cross` (when `cross`), `ln2`,
    `mlp` (routed experts when `moe`, else a dense MLP of width `d_ff`)."""

    def __init__(self, init: ParamInit, cfg: ModelConfig, d_ff: int, *,
                 moe: bool = False, cross: bool = False):
        super().__init__()
        self.ln1 = Norm(init, cfg.d_model, cfg.norm)
        self.attn = attn.init_mla(init, cfg) if cfg.attn == "mla" \
            else attn.init_gqa(init, cfg)
        if cross:
            self.ln_cross = Norm(init, cfg.d_model, cfg.norm)
            self.cross = attn.init_cross(init, cfg)
        self.ln2 = Norm(init, cfg.d_model, cfg.norm)
        self.mlp = moe_mod.init_moe(init, cfg) if moe \
            else moe_mod.init_dense_mlp(init, cfg, d_ff)


class MambaBlock(nn.Module):
    """One pre-norm Mamba2 block: `ln1`, `ssm`."""

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.ln1 = Norm(init, cfg.d_model, cfg.norm)
        self.ssm = ssm_mod.init_mamba2(init, cfg)


class Model(nn.Module):
    """`embed` [V, d], `lm_head` [d, V] (untied only), `ln_f`, and by
    family: `dense_layers` (when `first_dense_layers`) and `layers`
    (`Block`s; routed experts in the `moe` family), `layers` of
    `MambaBlock`s (ssm, hybrid) and `shared_block` (hybrid), or
    `enc_layers`, `dec_layers` (with cross-attention) and `ln_enc`
    (encdec)."""

    def __init__(self, cfg: ModelConfig, init: ParamInit):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(cfg.family)
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
        elif cfg.family == "encdec":
            self.enc_layers = nn.ModuleList(Block(init, cfg, cfg.d_ff)
                                            for _ in range(cfg.enc_layers))
            self.dec_layers = nn.ModuleList(
                Block(init, cfg, cfg.d_ff, cross=True)
                for _ in range(cfg.dec_layers))
            self.ln_enc = Norm(init, cfg.d_model, cfg.norm)
        else:
            n_dense = cfg.first_dense_layers
            if n_dense:
                self.dense_layers = nn.ModuleList(
                    Block(init, cfg, cfg.d_ff_dense or cfg.d_ff)
                    for _ in range(n_dense))
            self.layers = nn.ModuleList(
                Block(init, cfg, cfg.d_ff, moe=cfg.family == "moe")
                for _ in range(cfg.n_layers - n_dense))

    def head(self, dtype: torch.dtype) -> torch.Tensor:
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return w.to(dtype)


def init_model(cfg: ModelConfig, generator: torch.Generator = None, *,
               device="cuda") -> Model:
    """-> the model's parameters, drawn from `generator` (a CPU generator
    seeded with 0 when none is given; one on the card draws a large model
    faster) and placed on `device` in `cfg.param_dtype`.  The reference
    returns (params, specs); the specs belong to the parallel slice, which
    is not ported yet."""
    dev = as_device(device)
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    return Model(cfg, ParamInit(gen, dt(cfg.param_dtype), dev))


# ==========================================================================
# forward (train / prefill)
# ==========================================================================
def _attn_block_fwd(p: Block, cfg: ModelConfig, x, positions, *, moe: bool,
                    causal=True, window=0, enc_kv=None):
    h = norm(x, p.ln1, cfg.norm, cfg.norm_eps)
    if cfg.attn == "mla":
        a = attn.mla_forward(p.attn, cfg, h, positions, causal=causal,
                             window=window)
    else:
        a = attn.gqa_forward(p.attn, cfg, h, positions, causal=causal,
                             window=window)
    x = x + a
    if enc_kv is not None:
        h = norm(x, p.ln_cross, cfg.norm, cfg.norm_eps)
        x = x + attn.cross_forward(p.cross, cfg, h, enc_kv)
    h = norm(x, p.ln2, cfg.norm, cfg.norm_eps)
    if moe:
        return x + moe_mod.moe_mlp(p.mlp, cfg, h)
    return x + moe_mod.dense_mlp(p.mlp, cfg, h)


def _mamba_block_fwd(p: MambaBlock, cfg: ModelConfig, x):
    h = norm(x, p.ln1, cfg.norm, cfg.norm_eps)
    return x + ssm_mod.mamba2_forward(p.ssm, cfg, h)


def _logits(params: Model, cfg: ModelConfig, x, logits_mode: str):
    x = norm(x, params.ln_f, cfg.norm, cfg.norm_eps)
    if logits_mode == "hidden":
        return x
    if logits_mode == "last":
        x = x[:, -1:]
    return torch.einsum("bsd,dv->bsv", x, params.head(x.dtype))


def forward(params: Model, cfg: ModelConfig, batch: Dict[str, Any], *,
            remat: str = "dots_no_batch", logits_mode: str = "all"):
    """-> logits [B, S, V] (logits_mode="last": [B, 1, V], the serving
    prefill's; "hidden": the final normed states).

    batch keys by family:
      dense/moe/ssm/hybrid: tokens [B,S]
      vlm:                  embeds [B,S,D] and positions3 [3,B,S], or
                            tokens [B,S]
      encdec:               frames [B,Se,D], tokens [B,Sd]

    `remat` (a key of `REMAT_POLICIES`) applies to every layer block of a
    stack, as the reference's layer scans take it (the hybrid's shared
    block is not rematerialised there either); it changes memory, not
    values, and only while gradients are recorded.  Runs under the
    caller's grad mode; the flash and SSD kernels have no backward, so
    serving runs under `no_grad` (the Mamba2 layer takes its plain scan
    when gradients are recorded, `ssm.mamba2_forward`)."""
    cdt = dt(cfg.compute_dtype)
    dev = params.embed.device
    if cfg.family == "encdec":
        return _encdec_forward(params, cfg, batch, remat, logits_mode)
    if cfg.family == "vlm" and "embeds" in batch:
        x = torch.as_tensor(batch["embeds"], device=dev).to(cdt)
        positions = torch.as_tensor(batch["positions3"], device=dev)
    else:
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        b, s = tokens.shape
        x = embedding_lookup(params.embed, tokens).to(cdt)
        positions = torch.arange(s, device=dev)[None, :].expand(b, s)
        if cfg.rope == "mrope":
            positions = positions[None].expand(3, b, s)
    mamba = _remat(_mamba_block_fwd, remat)
    block = _remat(_attn_block_fwd, remat)
    if cfg.family == "ssm":
        for blk in params.layers:
            x = mamba(blk, cfg, x)
    elif cfg.family == "hybrid":
        k = cfg.shared_attn_every
        for gi in range(cfg.n_layers // k):
            for blk in params.layers[gi * k:(gi + 1) * k]:
                x = mamba(blk, cfg, x)
            x = _attn_block_fwd(params.shared_block, cfg, x, positions,
                                moe=False, window=cfg.sliding_window)
    else:
        if cfg.first_dense_layers:
            cfg_dense = dataclasses.replace(cfg,
                                            d_ff=cfg.d_ff_dense or cfg.d_ff)
            for blk in params.dense_layers:
                x = block(blk, cfg_dense, x, positions, moe=False)
        for blk in params.layers:
            x = block(blk, cfg, x, positions, moe=cfg.family == "moe",
                      window=cfg.sliding_window)
    return _logits(params, cfg, x, logits_mode)


def _dec_block_fwd(p: Block, cfg: ModelConfig, y, positions, enc_out):
    return _attn_block_fwd(p, cfg, y, positions, moe=False, causal=True,
                           enc_kv=attn.cross_kv(p.cross, cfg, enc_out))


def _encdec_forward(params: Model, cfg: ModelConfig, batch,
                    remat: str = "none", logits_mode: str = "all"):
    """Whisper: fixed sinusoidal positions; a non-causal encoder over the
    stub frame embeddings, normed by `ln_enc`; a causal decoder whose
    blocks cross-attend to the encoder's output."""
    cdt = dt(cfg.compute_dtype)
    dev = params.embed.device
    frames = torch.as_tensor(batch["frames"], device=dev).to(cdt)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    b, se = frames.shape[:2]
    sd = tokens.shape[1]
    pos_e = torch.arange(se, device=dev)[None, :].expand(b, se)
    pos_d = torch.arange(sd, device=dev)[None, :].expand(b, sd)
    x = frames + sinusoidal_positions(se, cfg.d_model).to(dev, cdt)[None]
    block = _remat(_attn_block_fwd, remat)
    for blk in params.enc_layers:
        x = block(blk, cfg, x, pos_e, moe=False, causal=False)
    enc_out = norm(x, params.ln_enc, cfg.norm, cfg.norm_eps)
    y = embedding_lookup(params.embed, tokens).to(cdt)
    y = y + sinusoidal_positions(sd, cfg.d_model).to(dev, cdt)[None]
    dec_block = _remat(_dec_block_fwd, remat)
    for blk in params.dec_layers:
        y = dec_block(blk, cfg, y, pos_d, enc_out)
    return _logits(params, cfg, y, logits_mode)


# ==========================================================================
# decode (single-token serve step against a cache)
# ==========================================================================
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> Dict[str, Any]:
    """Stacked per-layer caches for decode (`cache_specs` names their
    axes): GQA k/v [L, B, max_len, Hkv, hd]; MLA c_kv [L, B, max_len,
    kv_lora] and k_rope [L, B, max_len, rope]; for the ssm and hybrid
    families `layers` holds conv [L, B, K-1, conv_dim] (compute dtype) and
    ssm [L, B, H, N, P] (float32), and the hybrid's `shared` k/v
    [n_groups, ...]; encdec's `dec` k/v [dec_layers, ...] and `enc_out`
    [B, max_len, d] of zeros (nothing fills it, as in the reference)."""
    dev = as_device(device)
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
    if cfg.family == "encdec":
        return {"dec": stack(gqa, cfg.dec_layers),
                "enc_out": torch.zeros((batch, max_len, cfg.d_model),
                                       dtype=cdt, device=dev)}
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    make = gqa
    if cfg.attn == "mla":
        make = lambda: attn.mla_init_cache(cfg, batch, max_len, cdt, dev)
    cache = {"layers": stack(make, cfg.n_layers - cfg.first_dense_layers)}
    if cfg.first_dense_layers:
        cache["dense_layers"] = stack(make, cfg.first_dense_layers)
    return cache


def cache_specs(cfg: ModelConfig):
    """Logical-axis spec tree matching init_cache's structure."""
    gqa = {"k": ("layers", "batch", "kv_seq", "kv_heads", None),
           "v": ("layers", "batch", "kv_seq", "kv_heads", None)}
    mla = {"c_kv": ("layers", "batch", "kv_seq", None),
           "k_rope": ("layers", "batch", "kv_seq", None)}
    ssm = {"conv": ("layers", "batch", None, "ssm_inner"),
           "ssm": ("layers", "batch", "ssm_heads", None, None)}
    if cfg.family in ("dense", "moe", "vlm"):
        per = mla if cfg.attn == "mla" else gqa
        out = {"layers": per}
        if cfg.first_dense_layers:
            out["dense_layers"] = per
        return out
    if cfg.family == "ssm":
        return {"layers": ssm}
    if cfg.family == "hybrid":
        return {"layers": ssm, "shared": gqa}
    if cfg.family == "encdec":
        return {"dec": gqa,
                "enc_out": ("batch", "kv_seq", "embed")}
    raise ValueError(cfg.family)


def _attn_block_decode(p: Block, cfg: ModelConfig, x, cache, pos,
                       enc_out=None, absorb=False):
    h = norm(x, p.ln1, cfg.norm, cfg.norm_eps)
    if cfg.attn == "mla":
        a, cache = attn.mla_decode(p.attn, cfg, h, cache, pos, absorb=absorb)
    else:
        a, cache = attn.gqa_decode(p.attn, cfg, h, cache, pos,
                                   window=cfg.sliding_window)
    x = x + a
    if enc_out is not None:
        h = norm(x, p.ln_cross, cfg.norm, cfg.norm_eps)
        enc_kv = attn.cross_kv(p.cross, cfg, enc_out)
        x = x + attn.cross_forward(p.cross, cfg, h, enc_kv)
    h = norm(x, p.ln2, cfg.norm, cfg.norm_eps)
    if cfg.family == "moe" and isinstance(p.mlp, moe_mod.MoE):
        return x + moe_mod.moe_mlp(p.mlp, cfg, h), cache
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
    `attention.mla_decode`, `ssm.mamba2_decode`) and returned;
    `mla_absorb` picks MLA's weight-absorbed decode."""
    cdt = dt(cfg.compute_dtype)
    token = torch.as_tensor(token, device=params.embed.device)
    x = embedding_lookup(params.embed, token)[:, None, :].to(cdt)

    def layer(stacked, i):
        return {k: v[i] for k, v in stacked.items()}

    def run(blocks, stacked, cfg_b, x, enc_out=None):
        for i, blk in enumerate(blocks):
            x, _ = _attn_block_decode(blk, cfg_b, x, layer(stacked, i), pos,
                                      enc_out=enc_out, absorb=mla_absorb)
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
    elif cfg.family == "encdec":
        x = run(params.dec_layers, cache["dec"], cfg, x,
                enc_out=cache["enc_out"])
    else:
        if cfg.first_dense_layers:
            cfg_d = dataclasses.replace(cfg, d_ff=cfg.d_ff_dense or cfg.d_ff,
                                        family="dense")
            x = run(params.dense_layers, cache["dense_layers"], cfg_d, x)
        x = run(params.layers, cache["layers"], cfg, x)
    x = norm(x, params.ln_f, cfg.norm, cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, params.head(cdt))[:, 0]
    return logits, cache


# ==========================================================================
# training loss
# ==========================================================================
CE_CHUNK = 512  # sequence positions per cross-entropy chunk


def _chunk_nll(hc, tc, head):
    """Per-position negative log-likelihood [B, s] of targets `tc` [B, s]
    under the head's logits of hidden states `hc` [B, s, d], the
    log-softmax in float32."""
    logits = torch.einsum("bsd,dv->bsv", hc, head)
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -lp.gather(-1, tc[..., None])[..., 0]


def lm_loss(params: Model, cfg: ModelConfig, batch: Dict[str, Any], *,
            remat: str = "dots_no_batch"):
    """Next-token cross-entropy (float32 scalar), the mean over [B, S-1]:
    targets are `tokens` shifted by one (the vlm family's `labels` when
    the batch has them; encdec's decoder `tokens`).

    As in the reference, the head + log-softmax run in chunks of
    `CE_CHUNK` positions, each under `torch.utils.checkpoint`, only when
    S-1 is a multiple of CE_CHUNK larger than it; otherwise in one piece,
    which holds the [B, S-1, V] float32 log-probabilities for the
    backward pass (at S = 2048, S-1 = 2047 is not a multiple: one piece).
    """
    cdt = dt(cfg.compute_dtype)
    dev = params.embed.device
    hidden = forward(params, cfg, batch, remat=remat, logits_mode="hidden")
    tokens = batch["labels"] if cfg.family == "vlm" and "labels" in batch \
        else batch["tokens"]
    tokens = torch.as_tensor(tokens, device=dev).long()
    head = params.head(cdt)
    h = hidden[:, :-1]
    targets = tokens[:, 1:]
    b, sm1, _ = h.shape
    chunk = CE_CHUNK
    if sm1 % chunk != 0 or sm1 <= chunk:
        return _chunk_nll(h, targets, head).mean()
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(0, sm1, chunk):
        total = total + checkpoint(_chunk_nll, h[:, i:i + chunk],
                                   targets[:, i:i + chunk], head,
                                   use_reentrant=False).sum()
    return total / (b * sm1)
