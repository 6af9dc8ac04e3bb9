"""Model assembly for every family of `configs/registry.py`: the
decoder-only LM (`dense`, `moe`, `vlm`; GQA or MLA), the `ssm` family
(Mamba2), the `hybrid` family (Zamba2: Mamba2 layers with one shared GQA
block after every `shared_attn_every` of them) and `encdec` (Whisper: an
encoder, then a decoder with cross-attention); and the port's own
`hybrid_moe` family (Granite 4.0-H, configured by the benchmark rather
than the registry): Mamba2 and GQA layers in one stack by `layer_types`,
each followed by a dropless MoE with a shared expert, the residual
branches scaled by `residual_multiplier`.

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
from ..obs.trace import NULL_TRACER, current_tracer
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (Norm, ParamInit, dt, embedding_lookup, fold_tokens,
                     norm, shard, sinusoidal_positions)

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "hybrid_moe", "encdec")
#: the mixers of a `hybrid_moe` stack, by `layer_types` entry
HYBRID_MIXERS = ("mamba", "attention")
_aten = torch.ops.aten
_MM = (_aten.mm.default, _aten.addmm.default)
_BMM = (_aten.bmm.default, _aten.baddbmm.default)


def _saves_dot(batch_dims: bool):
    """A selective-checkpoint policy that saves the outputs of matrix
    products and recomputes everything else.  `x @ w` of a 3-D x and a
    2-D w lowers to `aten.mm` (the attention projections, `project_heads`
    and `merge_heads`, among them); every `torch.einsum` lowers to
    `aten.bmm`, one without batch dims as a bmm of batch 1.  With `batch_dims` every product is saved (JAX's
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


class HybridBlock(nn.Module):
    """One layer of the `hybrid_moe` family: `ln1`, its mixer (`ssm`, a
    Mamba2, where `kind` is "mamba"; `attn`, a GQA, where "attention"),
    `ln2`, and `mlp`, routed experts with their shared expert."""

    def __init__(self, init: ParamInit, cfg: ModelConfig, kind: str):
        super().__init__()
        if kind not in HYBRID_MIXERS:
            raise ValueError(f"layer type {kind!r} not in {HYBRID_MIXERS}")
        self.ln1 = Norm(init, cfg.d_model, cfg.norm)
        if kind == "mamba":
            self.ssm = ssm_mod.init_mamba2(init, cfg)
        else:
            self.attn = attn.init_gqa(init, cfg)
        self.ln2 = Norm(init, cfg.d_model, cfg.norm)
        self.mlp = moe_mod.init_moe(init, cfg)


class Model(nn.Module):
    """`embed` [V, d], `lm_head` [d, V] (untied only), `ln_f`, and by
    family: `dense_layers` (when `first_dense_layers`) and `layers`
    (`Block`s; routed experts in the `moe` family), `layers` of
    `MambaBlock`s (ssm, hybrid) and `shared_block` (hybrid), `layers` of
    `HybridBlock`s (hybrid_moe), or `enc_layers`, `dec_layers` (with
    cross-attention) and `ln_enc` (encdec)."""

    def __init__(self, cfg: ModelConfig, init: ParamInit):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(cfg.family)
        self.cfg = cfg
        self.embed = init.dense(cfg.vocab, cfg.d_model,
                                axes=("vocab", None), scale=0.02)
        if not cfg.tie_embeddings:
            self.lm_head = init.dense(cfg.d_model, cfg.vocab,
                                      axes=("embed", "vocab"), scale=0.02)
        self.ln_f = Norm(init, cfg.d_model, cfg.norm)
        if cfg.family in ("ssm", "hybrid"):
            self.layers = nn.ModuleList(MambaBlock(init, cfg)
                                        for _ in range(cfg.n_layers))
            if cfg.family == "hybrid":
                self.shared_block = Block(init, cfg, cfg.d_ff)
        elif cfg.family == "hybrid_moe":
            if len(cfg.layer_types) != cfg.n_layers:
                raise ValueError(f"{cfg.name}: {len(cfg.layer_types)} "
                                 f"layer_types for {cfg.n_layers} layers")
            self.layers = nn.ModuleList(HybridBlock(init, cfg, kind)
                                        for kind in cfg.layer_types)
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
    faster) and placed on `device` in `cfg.param_dtype` (on "meta":
    shapes only, nothing drawn).  The reference returns (params, specs);
    here each parameter carries its logical axes, and
    `layers.param_specs(model)` gives the name -> axes mapping that
    `parallel/sharding.py` resolves on a mesh."""
    dev = as_device(device)
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    return Model(cfg, ParamInit(gen, dt(cfg.param_dtype), dev))


# ==========================================================================
# forward (train / prefill)
# ==========================================================================
def _attn_block_fwd(p: Block, cfg: ModelConfig, x, positions, *, moe: bool,
                    causal=True, window=0, enc_kv=None, tr=NULL_TRACER):
    """One attention block; `tr` records its spans (`obs.MODEL_SPANS`)."""
    with tr.span("norm"):
        h = norm(x, p.ln1, cfg.norm, cfg.norm_eps)
    with tr.span("attn"):
        if cfg.attn == "mla":
            a = attn.mla_forward(p.attn, cfg, h, positions, causal=causal,
                                 window=window, tracer=tr)
        else:
            a = attn.gqa_forward(p.attn, cfg, h, positions, causal=causal,
                                 window=window, tracer=tr)
    x = x + a
    if enc_kv is not None:
        with tr.span("norm"):
            h = norm(x, p.ln_cross, cfg.norm, cfg.norm_eps)
        with tr.span("attn"):
            a = attn.cross_forward(p.cross, cfg, h, enc_kv, tracer=tr)
        x = x + a
    with tr.span("norm"):
        h = norm(x, p.ln2, cfg.norm, cfg.norm_eps)
    with tr.span("mlp"):
        y = moe_mod.moe_mlp(p.mlp, cfg, h) if moe \
            else moe_mod.dense_mlp(p.mlp, cfg, h)
    return x + y


def _mamba_block_fwd(p: MambaBlock, cfg: ModelConfig, x, tr=NULL_TRACER):
    with tr.span("norm"):
        h = norm(x, p.ln1, cfg.norm, cfg.norm_eps)
    with tr.span("ssm"):
        y = ssm_mod.mamba2_forward(p.ssm, cfg, h, tracer=tr)
    return x + y


def _hybrid_block_fwd(p: HybridBlock, cfg: ModelConfig, x, positions,
                      tr=NULL_TRACER):
    """One `hybrid_moe` layer: x + r mixer(norm(x)), then + r moe(norm(x)),
    r the residual multiplier."""
    r = cfg.residual_multiplier
    with tr.span("norm"):
        h = norm(x, p.ln1, cfg.norm, cfg.norm_eps)
    if hasattr(p, "ssm"):
        with tr.span("ssm"):
            a = ssm_mod.mamba2_forward(p.ssm, cfg, h, tracer=tr)
    else:
        with tr.span("attn"):
            a = attn.gqa_forward(p.attn, cfg, h, positions,
                                 window=cfg.sliding_window, tracer=tr)
    x = x + a * r
    with tr.span("norm"):
        h = norm(x, p.ln2, cfg.norm, cfg.norm_eps)
    with tr.span("mlp"):
        y = moe_mod.moe_mlp(p.mlp, cfg, h, tracer=tr)
    return x + y * r


def _scale_logits(cfg: ModelConfig, logits):
    """Logits divided by `logits_scaling` (Granite's), where it is not 1."""
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits


def _logits(params: Model, cfg: ModelConfig, x, logits_mode: str,
            tr=NULL_TRACER):
    with tr.span("norm"):
        x = norm(x, params.ln_f, cfg.norm, cfg.norm_eps)
    if logits_mode == "hidden":
        return x
    with tr.span("model.head"):
        if logits_mode == "last":
            x = x[:, -1:]
        head = params.head(x.dtype)
        return _scale_logits(cfg, torch.einsum(
            "bsd,dv->bsv", fold_tokens(x, head), head))


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
    caller's grad mode.  No kernel has a backward: the flash kernel and
    the grouped expert product raise under autograd, so serving runs under
    `no_grad`; the Mamba2 ops take their plain versions while gradients
    are recorded (`kernels/build.py::needs_grad`, `ssm.mamba2_forward`).

    The call records the spans of `obs.MODEL_SPANS` into the ambient
    tracer (`obs.current_tracer()`, read once a call; `NULL_TRACER`
    unless a scope activated one): no sync, values unchanged."""
    tr = current_tracer()
    with tr.span("model.forward", family=cfg.family) as call:
        if cfg.family == "encdec":
            return _encdec_forward(params, cfg, batch, remat, logits_mode,
                                   tr, call)
        cdt = dt(cfg.compute_dtype)
        dev = params.embed.device
        with tr.span("model.embed"):
            if cfg.family == "vlm" and "embeds" in batch:
                x = torch.as_tensor(batch["embeds"], device=dev).to(cdt)
                positions = torch.as_tensor(batch["positions3"], device=dev)
            else:
                tokens = torch.as_tensor(batch["tokens"], device=dev)
                b, s = tokens.shape
                x = embedding_lookup(params.embed, tokens).to(cdt)
                if cfg.embedding_multiplier != 1.0:
                    x = x * cfg.embedding_multiplier
                positions = torch.arange(s, device=dev)[None, :].expand(b, s)
                if cfg.rope == "mrope":
                    positions = positions[None].expand(3, b, s)
            x = shard(x, "batch", "seq", "embed")
        call.set(B=x.shape[0], S=x.shape[1])
        mamba = _remat(_mamba_block_fwd, remat)
        block = _remat(_attn_block_fwd, remat)
        if cfg.family == "ssm":
            for i, blk in enumerate(params.layers):
                with tr.span("model.block", layer=i):
                    x = mamba(blk, cfg, x, tr)
        elif cfg.family == "hybrid":
            k = cfg.shared_attn_every
            for gi in range(cfg.n_layers // k):
                for i in range(gi * k, (gi + 1) * k):
                    with tr.span("model.block", layer=i):
                        x = mamba(params.layers[i], cfg, x, tr)
                with tr.span("model.block", layer="shared"):
                    x = _attn_block_fwd(params.shared_block, cfg, x,
                                        positions, moe=False,
                                        window=cfg.sliding_window, tr=tr)
        elif cfg.family == "hybrid_moe":
            hybrid = _remat(_hybrid_block_fwd, remat)
            for i, blk in enumerate(params.layers):
                with tr.span("model.block", layer=i):
                    x = hybrid(blk, cfg, x, positions, tr)
        else:
            n_dense = cfg.first_dense_layers
            if n_dense:
                cfg_dense = dataclasses.replace(
                    cfg, d_ff=cfg.d_ff_dense or cfg.d_ff)
                for i, blk in enumerate(params.dense_layers):
                    with tr.span("model.block", layer=i):
                        x = block(blk, cfg_dense, x, positions, moe=False,
                                  tr=tr)
            for i, blk in enumerate(params.layers, n_dense):
                with tr.span("model.block", layer=i):
                    x = block(blk, cfg, x, positions,
                              moe=cfg.family == "moe",
                              window=cfg.sliding_window, tr=tr)
        out = _logits(params, cfg, x, logits_mode, tr)
        if logits_mode == "hidden":
            return out
        return shard(out, "batch", None, "vocab")


def _dec_block_fwd(p: Block, cfg: ModelConfig, y, positions, enc_out,
                   tr=NULL_TRACER):
    with tr.span("attn"):
        enc_kv = attn.cross_kv(p.cross, cfg, enc_out)
    return _attn_block_fwd(p, cfg, y, positions, moe=False, causal=True,
                           enc_kv=enc_kv, tr=tr)


def _encdec_forward(params: Model, cfg: ModelConfig, batch, remat: str,
                    logits_mode: str, tr, call):
    """Whisper: fixed sinusoidal positions; a non-causal encoder over the
    stub frame embeddings, normed by `ln_enc`; a causal decoder whose
    blocks cross-attend to the encoder's output.  `tr` records the spans,
    `call` is the call's own."""
    cdt = dt(cfg.compute_dtype)
    dev = params.embed.device
    with tr.span("model.embed"):
        frames = torch.as_tensor(batch["frames"], device=dev).to(cdt)
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        b, se = frames.shape[:2]
        sd = tokens.shape[1]
        pos_e = torch.arange(se, device=dev)[None, :].expand(b, se)
        pos_d = torch.arange(sd, device=dev)[None, :].expand(b, sd)
        x = frames + sinusoidal_positions(se, cfg.d_model).to(dev, cdt)[None]
    call.set(B=b, S=sd)
    block = _remat(_attn_block_fwd, remat)
    for i, blk in enumerate(params.enc_layers):
        with tr.span("model.block", layer=i):
            x = block(blk, cfg, x, pos_e, moe=False, causal=False, tr=tr)
    with tr.span("norm"):
        enc_out = norm(x, params.ln_enc, cfg.norm, cfg.norm_eps)
    with tr.span("model.embed"):
        y = embedding_lookup(params.embed, tokens).to(cdt)
        y = y + sinusoidal_positions(sd, cfg.d_model).to(dev, cdt)[None]
    dec_block = _remat(_dec_block_fwd, remat)
    for i, blk in enumerate(params.dec_layers, len(params.enc_layers)):
        with tr.span("model.block", layer=i):
            y = dec_block(blk, cfg, y, pos_d, enc_out, tr)
    return _logits(params, cfg, y, logits_mode, tr)


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
    [n_groups, ...]; hybrid_moe's `ssm` (conv, ssm) [n_mamba, ...] and
    `attn` k/v [n_attention, ...], layer i's at `hybrid_slots(cfg)[i]` of
    its kind; encdec's `dec` k/v [dec_layers, ...] and `enc_out`
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
    if cfg.family == "hybrid_moe":
        n_attn = cfg.layer_types.count("attention")
        return {"ssm": stack(lambda: ssm_mod.mamba2_init_state(
                    cfg, batch, cdt, dev), cfg.n_layers - n_attn),
                "attn": stack(gqa, n_attn)}
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
    if cfg.family == "hybrid_moe":
        return {"ssm": ssm, "attn": gqa}
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


def hybrid_slots(cfg: ModelConfig):
    """Each `hybrid_moe` layer's index into its kind's stacked cache (the
    Mamba2 layers before it, or the attention layers before it)."""
    seen = {kind: 0 for kind in HYBRID_MIXERS}
    out = []
    for kind in cfg.layer_types:
        out.append(seen[kind])
        seen[kind] += 1
    return out


def _hybrid_block_decode(p: HybridBlock, cfg: ModelConfig, x, cache,
                         slot: int, pos: int):
    """One `hybrid_moe` layer's decode step: its Mamba2 state (conv, ssm)
    or its k/v at `slot` of its kind, written in place."""
    r = cfg.residual_multiplier
    h = norm(x, p.ln1, cfg.norm, cfg.norm_eps)
    if hasattr(p, "ssm"):
        state = {k: v[slot] for k, v in cache["ssm"].items()}
        a, _ = ssm_mod.mamba2_decode(p.ssm, cfg, h, state)
    else:
        kv = {k: v[slot] for k, v in cache["attn"].items()}
        a, _ = attn.gqa_decode(p.attn, cfg, h, kv, pos,
                               window=cfg.sliding_window)
    x = x + a * r
    h = norm(x, p.ln2, cfg.norm, cfg.norm_eps)
    return x + moe_mod.moe_mlp(p.mlp, cfg, h) * r


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
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    x = shard(x, "batch", None, "embed")

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
    elif cfg.family == "hybrid_moe":
        for blk, slot in zip(params.layers, hybrid_slots(cfg)):
            x = _hybrid_block_decode(blk, cfg, x, cache, slot, pos)
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
    return _scale_logits(cfg, logits), cache


# ==========================================================================
# training loss
# ==========================================================================
CE_CHUNK = 512  # sequence positions per cross-entropy chunk


def _chunk_nll(hc, tc, head):
    """Per-position negative log-likelihood [B, s] of targets `tc` [B, s]
    under the head's logits of hidden states `hc` [B, s, d], the
    log-softmax in float32."""
    logits = shard(torch.einsum("bsd,dv->bsv", fold_tokens(hc, head), head),
                   "batch", None, "vocab")
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
