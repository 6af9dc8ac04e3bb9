"""The port's Mamba2 block (`repro_torch.models.ssm`) and the `ssm` and
`hybrid` families of its model against the JAX package's on the CPU, from
the same parameters (the JAX `init_model` tree loaded with
`convert.load_model_params`) and the same seeded numpy inputs, in float32
at `reduced_config("mamba2-2.7b")` (2 layers, d_model 64, 8 heads of 16,
d_state 16, chunk 16) and `reduced_config("zamba2-2.7b")` (4 Mamba2
layers, the shared GQA block after every 2, window 32).

Tolerances as in tests/test_torch_models.py: 1e-5 for one layer, 5e-5 for
the whole model (float32 sums in another order).  The port's prefill runs
the SSD scan through `ops.ssd_scan` (its plain version on the CPU), the
reference through `ssd_chunk_scan_streaming`; decode is the recurrence in
both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models import ssm as jax_ssm
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import (Model, decode_step, forward, init_cache,
                                init_model, layers, ssm)

ARCHS = ["mamba2-2.7b", "zamba2-2.7b"]
LAYER_TOL, MODEL_TOL = 1e-5, 5e-5


def _models(arch):
    """-> (jax cfg, jax params, port cfg, port model) with equal params."""
    cj, ct = jax_reduced_config(arch), reduced_config(arch)
    params, _ = jax_init_model(cj, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = convert.load_model_params(init_model(ct, device="cpu"), tree)
    return cj, params, ct, model


@pytest.fixture(scope="module")
def models():
    return {arch: _models(arch) for arch in ARCHS}


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _tokens(ct, shape, seed):
    return np.random.default_rng(seed).integers(0, ct.vocab, shape,
                                                dtype=np.int32)


def _layer0(pj, model):
    jp = jax.tree_util.tree_map(lambda a: a[0], pj["layers"])
    return jp["ssm"], model.layers[0].ssm


# ---------------------------------------------------------------------------
# one Mamba2 layer
# ---------------------------------------------------------------------------
def test_mamba2_params_keep_the_reference_names(models):
    cj, pj, ct, model = models["mamba2-2.7b"]
    jp, tp = _layer0(pj, model)
    assert {k for k, _ in tp.named_parameters()} == set(jp)
    for k, v in tp.named_parameters():
        assert tuple(v.shape) == jp[k].shape, k
    assert isinstance(tp.out_norm, torch.nn.Parameter)


def test_init_a_log_is_the_reference_constant():
    cj, ct = jax_reduced_config("mamba2-2.7b"), reduced_config("mamba2-2.7b")
    params, _ = jax_init_model(cj, jax.random.PRNGKey(0))
    model = init_model(ct, device="cpu")
    _close(model.layers[1].ssm.A_log, params["layers"]["ssm"]["A_log"][1],
           LAYER_TOL)
    for name in ("conv_b", "dt_bias", "D", "out_norm"):
        _close(getattr(model.layers[0].ssm, name),
               params["layers"]["ssm"][name][0], 0)


def test_param_init_const_casts():
    init = layers.ParamInit(torch.Generator(), torch.bfloat16,
                            torch.device("cpu"))
    p = init.const(np.array([1.5, 2.25]))
    assert p.dtype == torch.bfloat16 and p.tolist() == [1.5, 2.25]


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba2_forward_matches_jax(models, arch):
    cj, pj, ct, model = models[arch]
    jp, tp = _layer0(pj, model)
    x = np.random.default_rng(1).standard_normal(
        (2, 32, ct.d_model)).astype(np.float32)
    with torch.no_grad():
        got = ssm.mamba2_forward(tp, ct, torch.from_numpy(x))
    _close(got, jax_ssm.mamba2_forward(jp, cj, jnp.asarray(x)), LAYER_TOL)


def test_mamba2_forward_runs_the_op(models, monkeypatch):
    """The layer's SSD scan goes through `ops.ssd_scan` once, on views of
    the conv output."""
    _, _, ct, model = models["mamba2-2.7b"]
    seen = []
    real = ssd_ops.ssd_scan

    def spy(xh, dt, a, bh, ch, *, chunk):
        seen.append((tuple(xh.shape), tuple(bh.shape), chunk,
                     xh.is_contiguous()))
        return real(xh, dt, a, bh, ch, chunk=chunk)

    monkeypatch.setattr(ssd_ops, "ssd_scan", spy)
    x = torch.zeros(1, 16, ct.d_model)
    with torch.no_grad():
        ssm.mamba2_forward(model.layers[0].ssm, ct, x)
    h, p = ct.n_ssm_heads, ct.ssm_headdim
    assert seen == [((1, 16, h, p), (1, 16, ct.ssm_ngroups, ct.d_state),
                     ct.chunk, False)]


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba2_decode_matches_jax(models, arch):
    """Several steps of one layer: outputs and the state, written in place
    into the same dict."""
    cj, pj, ct, model = models[arch]
    jp, tp = _layer0(pj, model)
    sj = jax_ssm.mamba2_init_state(cj, 2, jnp.float32)
    st = ssm.mamba2_init_state(ct, 2, torch.float32, "cpu")
    conv, ssm_state = st["conv"], st["ssm"]
    xs = np.random.default_rng(2).standard_normal(
        (5, 2, 1, ct.d_model)).astype(np.float32)
    for x in xs:
        yj, sj = jax_ssm.mamba2_decode(jp, cj, jnp.asarray(x), sj)
        with torch.no_grad():
            yt, st2 = ssm.mamba2_decode(tp, ct, torch.from_numpy(x), st)
        assert st2 is st and st["conv"] is conv and st["ssm"] is ssm_state
        _close(yt, yj, LAYER_TOL)
    _close(st["conv"], sj["conv"], LAYER_TOL)
    _close(st["ssm"], sj["ssm"], LAYER_TOL)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("logits_mode", ["all", "last", "hidden"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(models, arch, logits_mode):
    cj, pj, ct, model = models[arch]
    toks = _tokens(ct, (2, 32), 5)
    want = jax_forward(pj, cj, {"tokens": jnp.asarray(toks)},
                       logits_mode=logits_mode)
    with torch.no_grad():
        got = forward(model, ct, {"tokens": torch.from_numpy(toks)},
                      logits_mode=logits_mode)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    cj, ct = jax_reduced_config(arch), reduced_config(arch)
    want = jax_init_cache(cj, 3, 24)
    got = init_cache(ct, 3, 24, device="cpu")
    assert {k: set(v) for k, v in got.items()} == \
        {k: set(v) for k, v in want.items()}
    for k, d in want.items():
        for kk, v in d.items():
            assert tuple(got[k][kk].shape) == v.shape, (k, kk)
            assert str(got[k][kk].dtype).removeprefix("torch.") == \
                str(v.dtype), (k, kk)
            assert not got[k][kk].any()


def test_init_cache_types_follow_the_compute_dtype():
    ct = dataclasses.replace(reduced_config("zamba2-2.7b"),
                             compute_dtype="bfloat16")
    cache = init_cache(ct, 1, 8, device="cpu")
    assert cache["layers"]["conv"].dtype == torch.bfloat16
    assert cache["layers"]["ssm"].dtype == torch.float32
    assert cache["shared"]["k"].shape[0] == \
        ct.n_layers // ct.shared_attn_every


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_step_by_step(models, arch):
    """Logits at every step and the caches at the end."""
    cj, pj, ct, model = models[arch]
    b, max_len, steps = 2, 24, 12
    toks = _tokens(ct, (b, steps), 7)
    cache_j = jax_init_cache(cj, b, max_len)
    cache_t = init_cache(ct, b, max_len, device="cpu")
    for pos in range(steps):
        lj, cache_j = jax_decode_step(pj, cj, cache_j,
                                      jnp.asarray(toks[:, pos]), pos)
        lt, cache_t = decode_step(model, ct, cache_t,
                                  torch.from_numpy(toks[:, pos]), pos)
        _close(lt, lj, MODEL_TOL)
    for group, d in cache_j.items():
        for name, v in d.items():
            _close(cache_t[group][name], v, MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(models, arch):
    """Teacher-forced decode reproduces the full forward's logits at every
    position (inside the port): the recurrence against the chunked scan."""
    _, _, ct, model = models[arch]
    toks = _tokens(ct, (3, 32), 8)
    with torch.no_grad():
        full = forward(model, ct, {"tokens": torch.from_numpy(toks)})
    cache = init_cache(ct, 3, 40, device="cpu")
    for pos in range(toks.shape[1]):
        logits, cache = decode_step(model, ct, cache,
                                    torch.from_numpy(toks[:, pos]), pos)
        _close(logits, full[:, pos].numpy(), MODEL_TOL)


def test_forward_launches_no_kernel_on_the_cpu(models):
    _, _, ct, model = models["mamba2-2.7b"]
    before = ssd_kernel.LAUNCHES["ssd"]
    with torch.no_grad():
        forward(model, ct, {"tokens": torch.zeros(1, 16, dtype=torch.long)})
    assert ssd_kernel.LAUNCHES["ssd"] == before


def test_forward_refuses_a_ragged_sequence(models):
    """T must be a multiple of the chunk, as the reference asserts."""
    _, _, ct, model = models["mamba2-2.7b"]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        with torch.no_grad():
            forward(model, ct, {"tokens": torch.zeros(1, 20,
                                                      dtype=torch.long)})


# ---------------------------------------------------------------------------
# parameters: layout and conversion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_model_layout(models, arch):
    _, _, ct, model = models[arch]
    assert isinstance(model, Model)
    assert len(model.layers) == ct.n_layers
    assert all(type(blk).__name__ == "MambaBlock" for blk in model.layers)
    assert hasattr(model, "shared_block") == (ct.family == "hybrid")
    assert not hasattr(model, "dense_layers")


@pytest.mark.parametrize("arch", ARCHS)
def test_conversion_carries_every_param(models, arch):
    """`load_model_params` walks the stacked `layers` and the hybrid's
    unstacked `shared_block` into the model, value for value."""
    _, pj, _, model = models[arch]
    state = convert.model_state_from_tree(
        jax.tree_util.tree_map(np.asarray, pj))
    params = dict(model.named_parameters())
    assert set(state) == set(params)
    for name, want in state.items():
        np.testing.assert_array_equal(params[name].detach().numpy(), want,
                                      err_msg=name)
    if arch == "zamba2-2.7b":
        assert "shared_block.attn.wq" in state
        assert "layers.3.ssm.A_log" in state


def test_conversion_refuses_a_foreign_family(models):
    _, pj, _, _ = models["mamba2-2.7b"]
    zamba = init_model(reduced_config("zamba2-2.7b"), device="cpu")
    with pytest.raises(KeyError, match="shared_block"):
        convert.load_model_params(zamba, jax.tree_util.tree_map(np.asarray,
                                                                pj))
