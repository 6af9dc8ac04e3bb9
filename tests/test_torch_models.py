"""The port's LM substrate (`repro_torch.models`) against the JAX package's
on the CPU, from the same parameters (the JAX `init_model` tree loaded
with `convert.load_model_params`) and the same seeded numpy inputs, in
float32 at `reduced_config("smollm-135m")` (2 layers, d_model 64, 4 query
heads on 2 KV heads of 16).  The flash cases use the same config with
head_dim 64, a width the port's kernel takes.

Tolerances: 1e-5 (absolute and relative) for one layer, and 5e-5 for the
whole forward and decode: float32 sums in another order (XLA's dot
against ATen's), a few units in the last place a product, through two
blocks and the LM head.  Observed errors are below 1e-6."""
import dataclasses
import sys
from pathlib import Path

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
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import (attention, cache_specs, decode_step, forward,
                                init_cache, init_model, layers, moe)

ARCH = "smollm-135m"
LAYER_TOL, MODEL_TOL = 1e-5, 5e-5


def _cfgs(head_dim=None):
    cj, ct = jax_reduced_config(ARCH), reduced_config(ARCH)
    if head_dim:
        cj = dataclasses.replace(cj, head_dim=head_dim)
        ct = dataclasses.replace(ct, head_dim=head_dim)
    return cj, ct


def _models(head_dim=None):
    """-> (jax cfg, jax params, port cfg, port model) with equal params."""
    cj, ct = _cfgs(head_dim)
    params, _ = jax_init_model(cj, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = convert.load_model_params(init_model(ct, device="cpu"), tree)
    return cj, params, ct, model


@pytest.fixture(scope="module")
def models():
    return {hd: _models(hd) for hd in (None, 64)}


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rms_norm():
    x, w = _rand(2, 5, 64), _rand(64, seed=1)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5),
           LAYER_TOL)


def test_layer_norm():
    x, w, b = _rand(2, 5, 64), _rand(64, seed=1), _rand(64, seed=2)
    _close(layers.layer_norm(*map(torch.from_numpy, (x, w, b))),
           jax_layers.layer_norm(*map(jnp.asarray, (x, w, b))), LAYER_TOL)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope(theta):
    x = _rand(2, 7, 4, 16)
    pos = np.broadcast_to(np.arange(7)[None], (2, 7)).astype(np.int32)
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta),
           jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           LAYER_TOL)


def test_apply_mrope():
    x = _rand(2, 7, 4, 16)
    pos3 = np.random.default_rng(3).integers(0, 9, (3, 2, 7)).astype(np.int32)
    _close(layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                              (2, 3, 3)),
           jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                  (2, 3, 3)), LAYER_TOL)


def test_sinusoidal_positions():
    _close(layers.sinusoidal_positions(9, 16),
           jax_layers.sinusoidal_positions(9, 16), 0)


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
def test_dense_mlp(act):
    cj, ct = (dataclasses.replace(c, act=act) for c in _cfgs())
    mlp = moe.init_dense_mlp(layers.ParamInit(torch.Generator().manual_seed(
        0), torch.float32, torch.device("cpu")), ct, ct.d_ff)
    x = _rand(2, 5, ct.d_model)
    _close(moe.dense_mlp(mlp, ct, torch.from_numpy(x)),
           jax_moe.dense_mlp({k: jnp.asarray(v.detach().numpy())
                              for k, v in mlp.named_parameters()}, cj,
                             jnp.asarray(x)), LAYER_TOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _layer0(cj_params, model):
    jp = jax.tree_util.tree_map(lambda a: a[0], cj_params["layers"])
    return jp, model.layers[0]


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 3)])
def test_gqa_forward(models, causal, window):
    cj, pj, ct, model = models[None]
    jp, tp = _layer0(pj, model)
    x = _rand(2, 9, ct.d_model)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    got = attention.gqa_forward(tp.attn, ct, torch.from_numpy(x),
                                torch.from_numpy(pos), causal=causal,
                                window=window)
    want = jax_attn.gqa_forward(jp["attn"], cj, jnp.asarray(x),
                                jnp.asarray(pos), causal=causal,
                                window=window)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5)])
def test_sdpa_blocked_matches_sdpa(causal, window):
    """Blocked online softmax against the plain path in the port, and
    against the reference's blocked path."""
    q, k, v = _rand(2, 32, 4, 16), _rand(2, 32, 2, 16, seed=1), \
        _rand(2, 32, 2, 16, seed=2)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attention.sdpa_blocked(tq, tk, tv, causal=causal, window=window,
                                 k_block=8)
    old = attention.BLOCKED_ATTN_THRESHOLD
    attention.set_blocked_threshold(1 << 30)          # force the plain path
    try:
        plain = attention.sdpa(tq, tk, tv, causal=causal, window=window)
    finally:
        attention.set_blocked_threshold(old)
    _close(got, plain.numpy(), LAYER_TOL)
    _close(got, jax_attn.sdpa_blocked(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      window=window, k_block=8), LAYER_TOL)


def test_sdpa_takes_the_blocked_path_above_the_threshold():
    q = torch.from_numpy(_rand(1, 16, 2, 16))
    old = attention.BLOCKED_ATTN_THRESHOLD
    attention.set_blocked_threshold(0)
    try:
        got = attention.sdpa(q, q, q)
    finally:
        attention.set_blocked_threshold(old)
    assert torch.equal(got, attention.sdpa_blocked(q, q, q))


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("logits_mode", ["all", "last"])
@pytest.mark.parametrize("head_dim,flash", [(None, False), (64, False),
                                            (64, True)],
                         ids=["reduced", "hd64", "hd64-flash"])
def test_forward_matches_jax(models, logits_mode, head_dim, flash):
    """Flash installed on both sides: the reference's Pallas kernel in
    interpret mode, the port's op (its plain version on the CPU)."""
    cj, pj, ct, model = models[head_dim]
    toks = np.random.default_rng(5).integers(0, ct.vocab, (2, 16),
                                             dtype=np.int32)
    if flash:
        jax_flash_ops.install(interpret=True)
        flash_ops.install()
    try:
        want = jax_forward(pj, cj, {"tokens": jnp.asarray(toks)},
                           logits_mode=logits_mode)
        with torch.no_grad():
            got = forward(model, ct, {"tokens": torch.from_numpy(toks)},
                          logits_mode=logits_mode)
    finally:
        jax_attn.set_flash_impl(None)
        attention.set_flash_impl(None)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, MODEL_TOL)


def test_forward_hidden_matches_jax(models):
    cj, pj, ct, model = models[None]
    toks = np.random.default_rng(6).integers(0, ct.vocab, (2, 8),
                                             dtype=np.int32)
    with torch.no_grad():
        got = forward(model, ct, {"tokens": torch.from_numpy(toks)},
                      logits_mode="hidden")
    _close(got, jax_forward(pj, cj, {"tokens": jnp.asarray(toks)},
                            logits_mode="hidden"), MODEL_TOL)


def test_decode_matches_jax_step_by_step(models):
    """Logits at every step and the caches at the end, including steps past
    max_len (the write clamps to the last slot in both)."""
    cj, pj, ct, model = models[None]
    b, max_len, steps = 2, 10, 12
    toks = np.random.default_rng(7).integers(0, ct.vocab, (b, steps),
                                             dtype=np.int32)
    cache_j = jax_init_cache(cj, b, max_len)
    cache_t = init_cache(ct, b, max_len, device="cpu")
    for pos in range(steps):
        lj, cache_j = jax_decode_step(pj, cj, cache_j,
                                      jnp.asarray(toks[:, pos]), pos)
        lt, cache_t = decode_step(model, ct, cache_t,
                                  torch.from_numpy(toks[:, pos]), pos)
        _close(lt, lj, MODEL_TOL)
    for name in ("k", "v"):
        _close(cache_t["layers"][name], cache_j["layers"][name], MODEL_TOL)


def test_decode_matches_forward(models):
    """Teacher-forced decode reproduces the full forward's logits at every
    position (inside the port)."""
    _, _, ct, model = models[None]
    toks = np.random.default_rng(8).integers(0, ct.vocab, (3, 11),
                                             dtype=np.int32)
    with torch.no_grad():
        full = forward(model, ct, {"tokens": torch.from_numpy(toks)})
    cache = init_cache(ct, 3, 16, device="cpu")
    for pos in range(toks.shape[1]):
        logits, cache = decode_step(model, ct, cache,
                                    torch.from_numpy(toks[:, pos]), pos)
        _close(logits, full[:, pos].numpy(), MODEL_TOL)


def test_first_dense_layers_match_jax():
    """A dense model with leading dense layers of their own width (the
    DeepSeek layout on the dense family)."""
    cj, ct = (dataclasses.replace(c, n_layers=3, first_dense_layers=1,
                                  d_ff_dense=96) for c in _cfgs())
    params, _ = jax_init_model(cj, jax.random.PRNGKey(1))
    model = convert.load_model_params(
        init_model(ct, device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
    assert len(model.dense_layers) == 1 and len(model.layers) == 2
    toks = np.random.default_rng(9).integers(0, ct.vocab, (2, 6),
                                             dtype=np.int32)
    with torch.no_grad():
        got = forward(model, ct, {"tokens": torch.from_numpy(toks)})
    _close(got, jax_forward(params, cj, {"tokens": jnp.asarray(toks)}),
           MODEL_TOL)
    cache_j, cache_t = jax_init_cache(cj, 2, 8), init_cache(ct, 2, 8,
                                                            device="cpu")
    for pos in range(3):
        lj, cache_j = jax_decode_step(params, cj, cache_j,
                                      jnp.asarray(toks[:, pos]), pos)
        lt, cache_t = decode_step(model, ct, cache_t,
                                  torch.from_numpy(toks[:, pos]), pos)
        _close(lt, lj, MODEL_TOL)


def test_untied_head_matches_jax():
    cj, ct = (dataclasses.replace(c, tie_embeddings=False, act="relu2")
              for c in _cfgs())
    params, _ = jax_init_model(cj, jax.random.PRNGKey(2))
    model = convert.load_model_params(
        init_model(ct, device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
    toks = np.random.default_rng(10).integers(0, ct.vocab, (1, 7),
                                              dtype=np.int32)
    with torch.no_grad():
        got = forward(model, ct, {"tokens": torch.from_numpy(toks)})
    _close(got, jax_forward(params, cj, {"tokens": jnp.asarray(toks)}),
           MODEL_TOL)


def test_load_model_params_refuses_a_foreign_tree(models):
    _, pj, ct, _ = models[None]
    tree = jax.tree_util.tree_map(np.asarray, pj)
    model = init_model(dataclasses.replace(ct, tie_embeddings=False),
                       device="cpu")
    with pytest.raises(KeyError, match="lm_head"):
        convert.load_model_params(model, tree)


# ==========================================================================
# The port's own `hybrid_moe` family (Granite 4.0-H; the JAX package has no
# counterpart): against the benchmark's plain float32 reference
# (`portbench/reference/granite_hybrid.py`), the dropless MoE against a
# loop over tokens, and decode through the two-kind cache against forward.
# ==========================================================================
HYBRID = ModelConfig(
    name="tiny-hybrid-moe", family="hybrid_moe", n_layers=4, d_model=64,
    vocab=128, n_heads=4, n_kv_heads=2, head_dim=16, rope="none",
    n_experts=8, top_k=3, n_shared_experts=1, d_expert=32, d_shared=48,
    capacity_factor=0.0, d_state=16, ssm_headdim=16, chunk=16,
    layer_types=("mamba", "attention", "mamba", "mamba"),
    embedding_multiplier=12.0, residual_multiplier=0.22,
    logits_scaling=16.0, attention_multiplier=1 / 16,
    param_dtype="float32", compute_dtype="float32")


def _granite_reference():
    """`portbench/reference/granite_hybrid.py` (the checkout's root on the
    path: the reference imports its siblings as `portbench.reference`)."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench.reference import granite_hybrid, plain
    return granite_hybrid, plain


def _hybrid(seed=0, **changes):
    cfg = dataclasses.replace(HYBRID, **changes)
    return cfg, init_model(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")


def _per_token_moe(p, cfg, x):
    """The routed experts and the shared expert token by token: top-k of
    the router's logits, softmax over them, each chosen expert's SwiGLU."""
    out = []
    for xt in x.reshape(-1, x.shape[-1]):
        top, idx = (xt @ p.router).topk(cfg.top_k)
        gates = torch.softmax(top, -1)
        y = (torch.nn.functional.silu(xt @ p.shared.w_gate)
             * (xt @ p.shared.w_up)) @ p.shared.w_down
        for g, e in zip(gates, idx):
            y = y + g * ((torch.nn.functional.silu(xt @ p.w_gate[e])
                          * (xt @ p.w_up[e])) @ p.w_down[e])
        out.append(y)
    return torch.stack(out).reshape(x.shape)


@pytest.mark.parametrize("rows", ["routed", "one_empty", "all_in_one"])
def test_grouped_product_equals_a_loop_over_rows(rows):
    """The grouped op's plain version (the CPU's path) against each row
    times its own expert's matrix: rows at random, with an expert given no
    row, and with every row in one expert."""
    from repro_torch.kernels.moe_grouped import ops as gops
    gen = torch.Generator().manual_seed(3)
    e, k, n, m = 6, 8, 5, 40
    ids = torch.randint(0, e, (m,), generator=gen)
    if rows == "one_empty":
        ids[ids == 2] = 3
    elif rows == "all_in_one":
        ids.fill_(4)
    order, offs = moe.sort_by_expert(ids, e)
    assert offs.dtype == torch.int32 and int(offs[-1]) == m
    x = torch.randn(m, k, generator=gen)
    w = torch.randn(e, k, n, generator=gen)
    got = gops.grouped_mm(x[order], w, offs)
    want = torch.stack([x[i] @ w[ids[i]] for i in order.tolist()])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert sorted(ids[order].tolist()) == ids[order].tolist()


@pytest.mark.parametrize("router", ["random", "skewed"])
def test_dropless_moe_drops_no_token(router):
    """The dropless MoE equals the token-by-token loop, also where a
    skewed router sends every token to one expert (where the capacity path
    drops tokens and differs)."""
    cfg, model = _hybrid(1)
    p = model.layers[0].mlp
    u = torch.ones(cfg.d_model) / cfg.d_model ** 0.5
    x = torch.randn(2, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(4)) + 4 * u
    with torch.no_grad():
        if router == "skewed":
            p.router[:, 5] = 20 * u
        got = moe.moe_mlp(p, cfg, x)
        want = _per_token_moe(p, cfg, x)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        if router == "skewed":
            _, _, top_i = moe._route(x.reshape(-1, cfg.d_model), p.router,
                                     cfg)
            assert (top_i == 5).any(-1).all()
            capped = moe.moe_mlp(p, dataclasses.replace(
                cfg, capacity_factor=1.25), x)
            assert (capped - want).abs().max() > 1e-3


def test_hybrid_moe_equals_the_plain_reference():
    """The float32 program's last-position logits against the benchmark's
    reference on the same weights, by parameter name."""
    ref, plain = _granite_reference()
    cfg, model = _hybrid(2)
    w = {n: t.detach() for n, t in model.named_parameters()}
    assert set(w) == set(ref.PARAMS(dataclasses.asdict(cfg)))
    toks = torch.randint(0, cfg.vocab, (2, 32),
                         generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = forward(model, cfg, {"tokens": toks}, logits_mode="last")
        want = ref.forward_last(w, dataclasses.asdict(cfg), toks,
                                plain.Products())
    torch.testing.assert_close(got[:, 0], want, rtol=1e-4, atol=1e-5)


def test_hybrid_moe_decode_equals_forward_and_the_reference():
    """Teacher-forced decode through `init_cache` (Mamba2 state for the
    Mamba2 layers, k/v for the attention layer, by layer index) equals the
    prefill's logits at every position, and the reference's at the last."""
    ref, plain = _granite_reference()
    cfg, model = _hybrid(3)
    toks = torch.randint(0, cfg.vocab, (2, 32),
                         generator=torch.Generator().manual_seed(6))
    cache = init_cache(cfg, 2, 32, device="cpu")
    assert {k: set(v) for k, v in cache.items()} == \
        {k: set(v) for k, v in cache_specs(cfg).items()}
    assert set(cache) == {"ssm", "attn"}
    assert cache["ssm"]["ssm"].shape[0] == 3
    assert cache["attn"]["k"].shape[:3] == (1, 2, 32)
    with torch.no_grad():
        full = forward(model, cfg, {"tokens": toks})
        for pos in range(toks.shape[1]):
            logits, cache = decode_step(model, cfg, cache, toks[:, pos], pos)
            torch.testing.assert_close(logits, full[:, pos], rtol=1e-4,
                                       atol=1e-5)
        w = {n: t.detach() for n, t in model.named_parameters()}
        want = ref.forward_last(w, dataclasses.asdict(cfg), toks,
                                plain.Products())
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-5)


def test_dropless_moe_refuses_dtensors():
    """Sharded experts or activations are not supported on the dropless
    path: a DTensor raises a clear error before any routing."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels.moe_grouped import ops as gops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    cfg, model = _hybrid(4)
    p = model.layers[0].mlp
    x = torch.randn(1, 16, cfg.d_model)
    with dryrun.fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        dx = DTensor.from_local(x, mesh, [Replicate(), Replicate()])
        with pytest.raises(NotImplementedError, match="one device"):
            moe.moe_mlp(p, cfg, dx)
        with pytest.raises(NotImplementedError, match="one device"):
            gops.grouped_mm(dx.reshape(16, cfg.d_model), p.w_gate,
                            torch.full((cfg.n_experts,), 16,
                                       dtype=torch.int32))

