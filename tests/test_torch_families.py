"""The port's `moe`, `vlm` and `encdec` families and MLA against the JAX
package on the CPU, from the same parameters (the JAX `init_model` tree
loaded with `convert.load_model_params`) and the same seeded numpy inputs,
in float32 at the `reduced_config` of seven configurations:
granite-moe-1b-a400m (routed experts), deepseek-v2-lite-16b (MLA without
a query LoRA, shared experts, one leading dense layer), minicpm3-4b (MLA
with a query LoRA), qwen2-vl-2b (M-RoPE), whisper-small (encoder,
decoder with cross-attention, layernorm, GELU), and the two dense
configurations no other file covers, phi3-mini-3.8b (SwiGLU; head dim 96
at full width) and nemotron-4-15b (squared ReLU, untied embeddings) in
the whole-model cases.

Tolerances as in tests/test_torch_models.py: 1e-5 (absolute and relative)
for one module, 5e-5 for a whole model.

Routing ties: `jax.lax.top_k` breaks ties to the lower index and
`torch.topk` promises nothing.  The router's inputs here are float32
values drawn from a normal distribution (or computed from such), so two
router probabilities of one token are equal with probability zero; no
test perturbs an input to avoid a tie."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.flash_attention import ops as jax_flash_ops
from repro.models import attention as jax_attn
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models import moe as jax_moe
from repro.models.model import cache_specs as jax_cache_specs
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.serve import main_lm
from repro_torch.models import (attention, cache_specs, decode_step,
                                forward, init_cache, init_model, moe)
from repro_torch.serve import Request, ServeEngine

LAYER_TOL, MODEL_TOL = 1e-5, 5e-5
ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b", "minicpm3-4b",
         "qwen2-vl-2b", "whisper-small", "phi3-mini-3.8b", "nemotron-4-15b"]
MLA_ARCHS = ["deepseek-v2-lite-16b", "minicpm3-4b"]
MOE_ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b"]


def _cfgs(arch, **changes):
    return tuple(dataclasses.replace(c, **changes)
                 for c in (jax_reduced_config(arch), reduced_config(arch)))


def _build(cj, ct, seed=0):
    """-> (jax params, port model) with equal parameters."""
    params, _ = jax_init_model(cj, jax.random.PRNGKey(seed))
    model = convert.load_model_params(
        init_model(ct, device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
    return params, model


@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, jax params, port cfg, port model)."""
    out = {}
    for arch in ARCHS:
        cj, ct = _cfgs(arch)
        params, model = _build(cj, ct)
        out[arch] = (cj, params, ct, model)
    return out


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _batch(cfg, b, s, seed):
    """The forward's inputs for `cfg`'s family, as numpy."""
    batch = {"tokens": _tokens(cfg.vocab, (b, s), seed)}
    if cfg.family == "encdec":
        batch["frames"] = _rand(b, s + 3, cfg.d_model, seed=seed + 1)
    return batch


def _layer(params, model, name="layers", i=0):
    return (jax.tree_util.tree_map(lambda a: a[i], params[name]),
            getattr(model, name)[i])


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pt(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
MOE_CASES = {
    # arch, config changes
    "granite": ("granite-moe-1b-a400m", {}),
    "granite-drops": ("granite-moe-1b-a400m", {"capacity_factor": 0.5}),
    "deepseek-shared": ("deepseek-v2-lite-16b", {}),
    "granite-gelu": ("granite-moe-1b-a400m", {"act": "gelu"}),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_mlp_matches_jax(case):
    """`moe_mlp` and its parts (routing and dispatch into the expert
    buffers, the expert MLPs, the combine) against the reference's.
    "granite-drops" sets the capacity factor to 0.5, so tokens are
    dropped (asserted), and the over-capacity writes into slot cap-1 must
    not disturb the token kept there."""
    arch, changes = MOE_CASES[case]
    cj, ct = _cfgs(arch, **changes)
    pj, model = _build(cj, ct)
    jp, tp = _layer(pj, model)
    jm, tm = jp["mlp"], tp.mlp
    assert isinstance(tm, moe.MoE)
    assert hasattr(tm, "shared") == bool(ct.n_shared_experts)
    x = _rand(3, 7, ct.d_model, seed=11)
    _close(moe.moe_mlp(tm, ct, torch.from_numpy(x)),
           jax_moe.moe_mlp(jm, cj, jnp.asarray(x)), LAYER_TOL)

    t = 21
    cap = moe.capacity(ct, t)
    assert cap == int(max(cj.top_k, (t * cj.top_k * cj.capacity_factor)
                          // cj.n_experts))
    xt = x.reshape(t, ct.d_model)
    buf, route = moe.moe_local_route_dispatch(torch.from_numpy(xt),
                                              tm.router, ct, cap)
    buf_j, route_j = jax_moe.moe_local_route_dispatch(
        jnp.asarray(xt), jm["router"], cj, cap)
    _close(buf, buf_j, LAYER_TOL)
    for got, want in zip(route[:3], route_j[:3]):     # experts, slots, keep
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(route[3], route_j[3], LAYER_TOL)
    if case == "granite-drops":
        assert not bool(route[2].all())
    out = moe.expert_ffn(buf, tm, ct)
    out_j = jax_moe.expert_ffn(buf_j, jm, cj)
    _close(out, out_j, LAYER_TOL)
    _close(moe.moe_combine(out, route, t, ct.top_k, ct.d_model, cap),
           jax_moe.moe_combine(out_j, route_j, t, cj.top_k, cj.d_model, cap),
           LAYER_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_load_balance_loss_matches_jax(models, arch):
    cj, pj, ct, model = models[arch]
    jp, tp = _layer(pj, model)
    x = _rand(2, 9, ct.d_model, seed=12)
    _close(moe.aux_load_balance_loss(tp.mlp, ct, torch.from_numpy(x)),
           jax_moe.aux_load_balance_loss(jp["mlp"], cj, jnp.asarray(x)),
           LAYER_TOL)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_forward_matches_jax(models, arch, causal):
    """With (minicpm3) and without (deepseek) the query LoRA."""
    cj, pj, ct, model = models[arch]
    jp, tp = _layer(pj, model)
    assert hasattr(tp.attn, "wq_a") == bool(ct.q_lora_rank)
    x = _rand(2, 9, ct.d_model, seed=13)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    _close(attention.mla_forward(tp.attn, ct, torch.from_numpy(x),
                                 torch.from_numpy(pos), causal=causal),
           jax_attn.mla_forward(jp["attn"], cj, jnp.asarray(x),
                                jnp.asarray(pos), causal=causal), LAYER_TOL)


@pytest.mark.parametrize("absorb", [False, True], ids=["plain", "absorbed"])
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_decode_matches_jax(models, arch, absorb):
    """Step by step from an empty latent cache, past its end (the write
    clamps to the last slot in both): outputs at every step and the
    caches at the end."""
    cj, pj, ct, model = models[arch]
    jp, tp = _layer(pj, model)
    b, max_len = 2, 6
    cache_j = jax_attn.mla_init_cache(cj, b, max_len, jnp.float32)
    cache_t = attention.mla_init_cache(ct, b, max_len, torch.float32)
    for pos in range(max_len + 2):
        x = _rand(b, 1, ct.d_model, seed=20 + pos)
        yj, cache_j = jax_attn.mla_decode(jp["attn"], cj, jnp.asarray(x),
                                          cache_j, pos, absorb=absorb)
        yt, cache_t = attention.mla_decode(tp.attn, ct, torch.from_numpy(x),
                                           cache_t, pos, absorb=absorb)
        _close(yt, yj, LAYER_TOL)
    for name in ("c_kv", "k_rope"):
        _close(cache_t[name], cache_j[name], LAYER_TOL)


# ---------------------------------------------------------------------------
# cross-attention and M-RoPE decode
# ---------------------------------------------------------------------------
def test_cross_attention_matches_jax(models):
    cj, pj, ct, model = models["whisper-small"]
    jp, tp = _layer(pj, model, "dec_layers", 1)
    enc, x = _rand(2, 11, ct.d_model, seed=14), _rand(2, 5, ct.d_model,
                                                      seed=15)
    kv_t = attention.cross_kv(tp.cross, ct, torch.from_numpy(enc))
    kv_j = jax_attn.cross_kv(jp["cross"], cj, jnp.asarray(enc))
    for name in ("k", "v"):
        _close(kv_t[name], kv_j[name], LAYER_TOL)
    _close(attention.cross_forward(tp.cross, ct, torch.from_numpy(x), kv_t),
           jax_attn.cross_forward(jp["cross"], cj, jnp.asarray(x), kv_j),
           LAYER_TOL)


@pytest.mark.parametrize("b", [1, 2, 4])
def test_mrope_gqa_decode_matches_jax(models, b):
    """The reference feeds `posv` [B, 1] to M-RoPE as positions3; at B < 3
    JAX clamps the index.  The port broadcasts pos to [3, B, 1]: the same
    numbers at every B."""
    cj, pj, ct, model = models["qwen2-vl-2b"]
    jp, tp = _layer(pj, model)
    max_len = 5
    cache_j = jax_attn.gqa_init_cache(cj, b, max_len, jnp.float32)
    cache_t = attention.gqa_init_cache(ct, b, max_len, torch.float32)
    for pos in range(max_len):
        x = _rand(b, 1, ct.d_model, seed=30 + pos)
        yj, cache_j = jax_attn.gqa_decode(jp["attn"], cj, jnp.asarray(x),
                                          cache_j, pos)
        yt, cache_t = attention.gqa_decode(tp.attn, ct, torch.from_numpy(x),
                                           cache_t, pos)
        _close(yt, yj, LAYER_TOL)
    _close(cache_t["k"], cache_j["k"], LAYER_TOL)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("logits_mode", ["all", "last", "hidden"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(models, arch, logits_mode):
    cj, pj, ct, model = models[arch]
    batch = _batch(ct, 2, 12, seed=40)
    want = jax_forward(pj, cj, _jnp(batch), logits_mode=logits_mode)
    with torch.no_grad():
        got = forward(model, ct, _pt(batch), logits_mode=logits_mode)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, MODEL_TOL)


def test_vlm_embeds_forward_matches_jax(models):
    """qwen2-vl's stub patch embeddings with their own (t, h, w)
    positions, as the reference's `embeds`/`positions3` input."""
    cj, pj, ct, model = models["qwen2-vl-2b"]
    batch = {"embeds": _rand(2, 10, ct.d_model, seed=41),
             "positions3": np.random.default_rng(42).integers(
                 0, 16, (3, 2, 10)).astype(np.int32)}
    want = jax_forward(pj, cj, _jnp(batch))
    with torch.no_grad():
        got = forward(model, ct, _pt(batch))
    _close(got, want, MODEL_TOL)


DECODE_CASES = [(a, False) for a in ARCHS] + [(a, True) for a in MLA_ARCHS]


@pytest.mark.parametrize("arch,absorb", DECODE_CASES,
                         ids=[f"{a}{'-absorbed' if m else ''}"
                              for a, m in DECODE_CASES])
def test_decode_matches_jax_step_by_step(models, arch, absorb):
    """Logits at every step and every cache tensor at the end, including
    steps past max_len (the write clamps to the last slot in both)."""
    cj, pj, ct, model = models[arch]
    b, max_len, steps = 2, 8, 10
    toks = _tokens(ct.vocab, (b, steps), seed=50)
    cache_j = jax_init_cache(cj, b, max_len)
    cache_t = init_cache(ct, b, max_len, device="cpu")
    for pos in range(steps):
        lj, cache_j = jax_decode_step(pj, cj, cache_j,
                                      jnp.asarray(toks[:, pos]), pos,
                                      mla_absorb=absorb)
        lt, cache_t = decode_step(model, ct, cache_t,
                                  torch.from_numpy(toks[:, pos]), pos,
                                  mla_absorb=absorb)
        _close(lt, lj, MODEL_TOL)
    flat_j = jax.tree_util.tree_flatten_with_path(cache_j)[0]
    assert len(flat_j) == sum(len(v) if isinstance(v, dict) else 1
                              for v in cache_t.values())
    for path, want in flat_j:
        got = cache_t
        for key in path:
            got = got[key.key]
        _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("arch,absorb",
                         [(a, False) for a in ARCHS if a != "whisper-small"]
                         + [(a, True) for a in MLA_ARCHS])
def test_decode_matches_forward(arch, absorb):
    """Teacher-forced decode reproduces the full forward's logits at every
    position (inside the port).  The MoE capacity depends on the number of
    tokens routed at once (B at decode, B*S in the forward), so the
    capacity factor is set to E/k, where no expert can overflow in either
    and both route every token.  whisper-small is not a case: the
    reference's decode adds no sinusoidal positions and cross-attends to
    the cache's `enc_out`, so it is not the forward's decoder."""
    cj, ct = _cfgs(arch)
    if ct.n_experts:
        cj, ct = _cfgs(arch, capacity_factor=ct.n_experts / ct.top_k)
    _, model = _build(cj, ct)
    toks = _tokens(ct.vocab, (3, 11), seed=60)
    with torch.no_grad():
        full = forward(model, ct, {"tokens": torch.from_numpy(toks)})
    cache = init_cache(ct, 3, 16, device="cpu")
    for pos in range(toks.shape[1]):
        logits, cache = decode_step(model, ct, cache,
                                    torch.from_numpy(toks[:, pos]), pos,
                                    mla_absorb=absorb)
        _close(logits, full[:, pos].numpy(), MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_specs(arch):
    """Every cache tensor has the reference's shape and dtype, and as many
    axes as `cache_specs` names (which equals the reference's)."""
    cj, ct = _cfgs(arch)
    specs = cache_specs(ct)
    assert specs == jax_cache_specs(cj)
    cache_t = init_cache(ct, 3, 7, device="cpu")
    cache_j = jax_init_cache(cj, 3, 7)
    assert set(cache_t) == set(specs) == set(cache_j)
    for key, spec in specs.items():
        if isinstance(spec, dict):
            pairs = [(cache_t[key][n], cache_j[key][n], spec[n])
                     for n in spec]
            assert set(cache_t[key]) == set(spec)
        else:
            pairs = [(cache_t[key], cache_j[key], spec)]
        for got, want, axes in pairs:
            assert tuple(got.shape) == tuple(want.shape)
            assert got.dim() == len(axes)
            assert str(got.dtype)[6:] == str(want.dtype)
            assert not got.any()


def test_first_dense_layers_take_the_dense_mlp(models):
    """deepseek's leading layer is dense at `d_ff_dense`, the rest routed,
    in forward and in decode (the reference decides by `router` in the
    layer's MLP params and the family)."""
    _, pj, ct, model = models["deepseek-v2-lite-16b"]
    assert ct.first_dense_layers == 1 and len(model.dense_layers) == 1
    assert isinstance(model.dense_layers[0].mlp, moe.DenseMLP)
    assert model.dense_layers[0].mlp.w_gate.shape[1] == ct.d_ff_dense
    assert all(isinstance(b.mlp, moe.MoE) for b in model.layers)
    assert "router" not in pj["dense_layers"]["mlp"]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax(arch):
    """The port's `ServeEngine` against the JAX engine, from the same
    parameters and requests: equal tokens for every request (whisper's
    `enc_out` stays zeros in both, as the reference's engine never fills
    it)."""
    cj, ct = _cfgs(arch)
    params, model = _build(cj, ct)
    ref = JaxServeEngine(cj, params, batch=2, max_len=16)
    eng = ServeEngine(ct, model, batch=2, max_len=16, device="cpu")
    rng_j, rng_t = np.random.default_rng(70), np.random.default_rng(70)
    for rid in range(4):
        ref.submit(JaxRequest(rid=rid, prompt=rng_j.integers(
            0, cj.vocab, int(rng_j.integers(1, 6))).astype(np.int32),
            max_new_tokens=3))
        eng.submit(Request(rid=rid, prompt=rng_t.integers(
            0, ct.vocab, int(rng_t.integers(1, 6))).astype(np.int32),
            max_new_tokens=3))
    assert eng.run_until_drained() == ref.run_until_drained()
    assert sorted(eng.done) == sorted(ref.done) == list(range(4))
    for rid in ref.done:
        assert eng.done[rid].out_tokens == ref.done[rid].out_tokens, rid


@pytest.mark.parametrize("arch", ARCHS)
def test_main_lm_serves_every_family(arch, capsys):
    main_lm(["--arch", arch, "--device", "cpu", "--requests", "3",
             "--max-new-tokens", "2", "--max-len", "32"])
    out = capsys.readouterr().out
    assert f"[serve] {arch}: 3 requests, 9 tokens" in out


# ---------------------------------------------------------------------------
# the flash hook on the new paths
# ---------------------------------------------------------------------------
# the configs at head_dim 64, a width the port's flash op takes; qwen2-vl's
# M-RoPE sections re-cut to the 32 rotary pairs of that width.  Expected
# calls of the hook per forward: every causal self-attention of equal
# q/k and v head dims, as `sdpa` decides (MLA and whisper's encoder and
# cross-attention take the plain path).
FLASH_CASES = {"granite-moe-1b-a400m": ({}, 2),
               "qwen2-vl-2b": ({"mrope_sections": (8, 12, 12)}, 2),
               "whisper-small": ({}, 2),
               "minicpm3-4b": ({}, 0),
               "deepseek-v2-lite-16b": ({}, 0)}


@pytest.mark.parametrize("arch", list(FLASH_CASES))
def test_forward_with_flash_matches_jax(arch):
    """Flash installed on both sides (the reference's Pallas kernel in
    interpret mode, the port's op, its plain version on the CPU): equal
    logits, and the hook called where the reference calls it."""
    changes, want_calls = FLASH_CASES[arch]
    cj, ct = _cfgs(arch, head_dim=64, **changes)
    pj, model = _build(cj, ct)
    batch = _batch(ct, 2, 16, seed=80)
    calls = []
    jax_flash_ops.install(interpret=True)
    flash_ops.install()
    impl = attention._FLASH_IMPL
    attention.set_flash_impl(
        lambda *a, **kw: calls.append(1) or impl(*a, **kw))
    try:
        want = jax_forward(pj, cj, _jnp(batch))
        with torch.no_grad():
            got = forward(model, ct, _pt(batch))
    finally:
        jax_attn.set_flash_impl(None)
        attention.set_flash_impl(None)
    assert len(calls) == want_calls
    _close(got, want, MODEL_TOL)
