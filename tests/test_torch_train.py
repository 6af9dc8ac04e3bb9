"""The port's training path (`repro_torch.{data,train,parallel,launch.train}`
and `models.lm_loss` / `remat`) against the JAX package on the CPU, from
the same parameters (the JAX `init_model` tree loaded with
`convert.load_model_params`) and the same seeded numpy inputs, at the
`reduced_config` of each family (float32).

Tolerances:
  * data batches and int8 codes: exactly equal;
  * optimizer state (m, v, master): 1e-6 relative (float32 sums in another
    order, a fused multiply-add where XLA rounds twice); params 1e-4 of
    one step's size `lr` (Adam normalises each element, so a rounding in
    an element with |g| near eps moves it by up to lr);
  * `lm_loss`: 1e-5 relative; every gradient within 1e-4 of the largest
    |g| of its leaf (float32 through two blocks and the head, forward and
    backward: observed below 2e-5);
  * train steps: loss and grad_norm 1e-5 relative, lr 1e-6 (the port's
    lr is float64 on the host, the reference's float32), params 1e-2 of
    lr per step (from the second step on, m / sqrt(v) amplifies rounding
    where successive gradients of an element nearly cancel: 2 of 4,096
    elements of a leaf moved 3.3e-3 lr apart in three steps);
  * the microbatch contract: the reference test's own (loss 1e-3
    relative, params 5e-3).

The reference's global hooks (activation sharding, embedding lookup,
flash, expert parallelism) are reset before each JAX call: another test
file in the same worker may leave them installed (`launch/steps.py`
installs the sharding hook), and the reference then runs another
program."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.data import pipeline as jax_pipeline
from repro.models import attention as jax_attention
from repro.models import init_model as jax_init_model
from repro.models import layers as jax_layers
from repro.models import lm_loss as jax_lm_loss
from repro.models import moe as jax_moe
from repro.parallel import collectives as jax_coll
from repro.train import checkpoint as jax_ckpt
from repro.train import optimizer as jax_opt
from repro.train import resilience as jax_resilience
from repro.train import train_step as jax_ts
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.data import pipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import REMAT_POLICIES, init_model, lm_loss
from repro_torch.parallel import collectives as coll
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import resilience
from repro_torch.train import train_step as ts

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
STATE_RTOL, PARAM_LR_TOL, STEP_LR_TOL = 1e-6, 1e-4, 1e-2


def _reset_reference_hooks():
    jax_layers.set_shard_fn(None)
    jax_layers.set_embed_lookup(None)
    jax_attention.set_flash_impl(None)
    jax_moe.set_moe_ep_impl(None)


@pytest.fixture(autouse=True)
def _reference_hooks_off():
    _reset_reference_hooks()


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pt(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _build(arch, seed=0, **changes):
    """-> (jax cfg, jax params, port cfg, port model), equal params."""
    cj = dataclasses.replace(jax_reduced_config(arch), **changes)
    ct = dataclasses.replace(reduced_config(arch), **changes)
    params, _ = jax_init_model(cj, jax.random.PRNGKey(seed))
    model = convert.load_model_params(
        init_model(ct, device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
    return cj, params, ct, model


def _names(tree):
    """A reference params-shaped tree -> {port param name: array}."""
    return convert.model_state_from_tree(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree))


def _leafwise_close(got: dict, want: dict, frac):
    """Every leaf of `got` within `frac` of the largest |value| of the
    same leaf of `want`."""
    assert set(got) == set(want)
    for name, w in want.items():
        g = _np(got[name])
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= frac * scale, (name, err, scale)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
DATA_CASES = [(0, 0, 1, 0), (3, 5, 1, 0), (3, 5, 2, 0), (3, 5, 2, 1),
              (11, 123, 4, 3)]


@pytest.mark.parametrize("seed,index,hosts,host", DATA_CASES)
def test_synthetic_batches_equal_reference(seed, index, hosts, host):
    kw = dict(seq_len=17, global_batch=8, vocab=100, seed=seed,
              num_hosts=hosts, host_id=host)
    got = pipeline.SyntheticLM(pipeline.DataConfig(**kw)).batch(index)
    want = jax_pipeline.SyntheticLM(
        jax_pipeline.DataConfig(**kw)).batch(index)
    assert got.keys() == want.keys()
    assert got["tokens"].dtype == want["tokens"].dtype
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("seed,index,hosts,host", DATA_CASES)
def test_memmap_batches_equal_reference(tmp_path, seed, index, hosts, host):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(seed).integers(
        0, 50000, 10000, dtype=np.int32).tofile(path)
    kw = dict(seq_len=32, global_batch=8, vocab=50000, seed=seed,
              path=path, num_hosts=hosts, host_id=host)
    src = pipeline.make_source(pipeline.DataConfig(**kw))
    assert isinstance(src, pipeline.MemmapTokens)
    want = jax_pipeline.make_source(
        jax_pipeline.DataConfig(**kw)).batch(index)["tokens"]
    np.testing.assert_array_equal(src.batch(index)["tokens"], want)


def test_synthetic_stream_is_stateless_by_index():
    cfg = pipeline.DataConfig(seq_len=16, global_batch=4, vocab=64, seed=2)
    it = iter(pipeline.SyntheticLM(cfg))
    for i in range(3):
        np.testing.assert_array_equal(
            next(it)["tokens"], pipeline.SyntheticLM(cfg).batch(i)["tokens"])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 5), (0, 0),
                                          (100, 50)])
def test_lr_schedule_equals_reference(warmup, total):
    cfg_t = opt.OptConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    cfg_j = jax_opt.OptConfig(lr=3e-4, warmup_steps=warmup,
                              total_steps=total)
    for step in range(0, max(total, warmup) + 5):
        want = float(jax_opt.lr_at(cfg_j, jnp.int32(step)))
        assert opt.lr_at(cfg_t, step) == pytest.approx(want, rel=1e-6,
                                                       abs=1e-12)


def test_lr_schedule_shapes():
    cfg = opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_ratio=0.1)
    assert opt.lr_at(cfg, 0) == 0.0
    assert opt.lr_at(cfg, 10) == pytest.approx(1.0)
    assert opt.lr_at(cfg, 100) == pytest.approx(0.1)


def _random_tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 24)).astype(dtype),
            "b": rng.standard_normal((24,)).astype(dtype),
            "e": (rng.standard_normal((5, 3, 4)) * 10).astype(dtype)}


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "noclip"])
@pytest.mark.parametrize("master", [True, False], ids=["master", "nomaster"])
def test_apply_updates_matches_reference(clip, master):
    """Three updates from the same params and gradients: m, v and master
    within 1e-6 relative, params within 1e-4 of lr a step, and the
    metrics (grad_norm, lr)."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip,
              master_fp32=master)
    cfg_t, cfg_j = opt.OptConfig(**kw), jax_opt.OptConfig(**kw)
    init = _random_tree(0)
    pj = {k: jnp.asarray(v) for k, v in init.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    sj, st = jax_opt.init_opt_state(cfg_j, pj), opt.init_opt_state(cfg_t, pt)
    for i in range(3):
        grads = _random_tree(10 + i)
        pj, sj, mj = jax_opt.apply_updates(
            cfg_j, pj, {k: jnp.asarray(v) for k, v in grads.items()}, sj)
        _, st, mt = opt.apply_updates(cfg_t, pt, _pt(grads), st)
        assert st.step == int(sj.step) == i + 1
        assert mt["lr"] == pytest.approx(float(mj["lr"]), rel=1e-6)
        assert float(mt["grad_norm"]) == pytest.approx(
            float(mj["grad_norm"]), rel=1e-6)
        for part in ("m", "v") + (("master",) if master else ()):
            for k in init:
                np.testing.assert_allclose(
                    _np(getattr(st, part)[k]),
                    np.asarray(getattr(sj, part)[k]), rtol=STATE_RTOL,
                    atol=STATE_RTOL * float(np.abs(
                        np.asarray(getattr(sj, part)[k])).max()))
        for k in init:
            np.testing.assert_allclose(_np(pt[k]), np.asarray(pj[k]),
                                       rtol=0, atol=PARAM_LR_TOL * 1e-2
                                       * (i + 1))
    assert st.master is None if not master else st.master.keys() == pt.keys()


def test_apply_updates_bf16_params_keep_a_float32_master():
    """bf16 params: the update runs on the float32 master and the params
    are its bf16 rounding, as in the reference."""
    cfg_t = opt.OptConfig(lr=1e-2, warmup_steps=1)
    cfg_j = jax_opt.OptConfig(lr=1e-2, warmup_steps=1)
    init = _random_tree(1)
    pj = {k: jnp.asarray(v, jnp.bfloat16) for k, v in init.items()}
    pt = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in init.items()}
    sj, st = jax_opt.init_opt_state(cfg_j, pj), opt.init_opt_state(cfg_t, pt)
    grads = _random_tree(2)
    pj, sj, _ = jax_opt.apply_updates(cfg_j, pj, _jnp(grads), sj)
    opt.apply_updates(cfg_t, pt, _pt(grads), st)
    for k in init:
        assert pt[k].dtype == torch.bfloat16
        assert st.master[k].dtype == torch.float32
        np.testing.assert_allclose(_np(st.master[k]), np.asarray(
            sj.master[k]), rtol=STATE_RTOL, atol=PARAM_LR_TOL * 1e-2)
        torch.testing.assert_close(pt[k], st.master[k].to(torch.bfloat16),
                                   rtol=0, atol=0)


def test_adamw_converges_quadratic():
    cfg = opt.OptConfig(lr=0.1, warmup_steps=1, total_steps=200,
                        weight_decay=0.0, clip_norm=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init_opt_state(cfg, params)
    for _ in range(150):
        opt.apply_updates(cfg, params, {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 1e-2


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def test_int8_compression_matches_reference():
    """Five rounds of error feedback: int8 codes exactly equal, scales,
    decompressed grads and error states within 1e-7 of the values."""
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((32, 7)).astype(np.float32),
            "b": np.array([0.001, -0.5, 2.7, 1e-5, 0.0], np.float32),
            "c": (rng.standard_normal((3, 3)) * 1e-3).astype(np.float32)}
    err_j = jax_coll.init_error_state({k: jnp.asarray(v)
                                       for k, v in tree.items()})
    err_t = coll.init_error_state(_pt(tree))
    for _ in range(5):
        deq_j, err_j = jax_coll.compress_grads_inplace(_jnp(tree), err_j)
        deq_t, err_t = coll.compress_grads_inplace(_pt(tree), err_t)
        for k in tree:
            np.testing.assert_allclose(_np(deq_t[k]), np.asarray(deq_j[k]),
                                       rtol=1e-7, atol=1e-7)
            np.testing.assert_allclose(_np(err_t[k]), np.asarray(err_j[k]),
                                       rtol=1e-7, atol=1e-7)
    for k, v in tree.items():
        qt, st_ = coll.quantize_int8(torch.from_numpy(v))
        qj, sj_ = jax_coll.quantize_int8(jnp.asarray(v))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert float(st_) == pytest.approx(float(sj_), rel=1e-7)


def test_stacked_blocks_share_one_scale_as_the_reference():
    """The blocks of a layer stack are one array in the reference, with
    one scale: the port groups them by name and quantizes alike."""
    assert coll.scale_groups(["embed", "layers.0.attn.wq", "layers.1.attn.wq",
                              "dec_layers.3.cross.wk", "dec_layers.0.cross.wk",
                              "ln_f.scale"]) == [
        ["embed"], ["layers.0.attn.wq", "layers.1.attn.wq"],
        ["dec_layers.3.cross.wk", "dec_layers.0.cross.wk"], ["ln_f.scale"]]
    rng = np.random.default_rng(5)
    stack = rng.standard_normal((3, 4, 5)).astype(np.float32)
    stack[1] *= 100                       # one block sets the scale
    deq_j, err_j = jax_coll.compress_grads_inplace(
        {"w": jnp.asarray(stack)}, {"w": jnp.zeros(stack.shape)})
    grads = {f"layers.{i}.w": torch.from_numpy(stack[i]) for i in range(3)}
    deq_t, err_t = coll.compress_grads_inplace(grads,
                                               coll.init_error_state(grads))
    for i in range(3):
        np.testing.assert_allclose(deq_t[f"layers.{i}.w"].numpy(),
                                   np.asarray(deq_j["w"][i]), rtol=1e-7,
                                   atol=1e-7)
        np.testing.assert_allclose(err_t[f"layers.{i}.w"].numpy(),
                                   np.asarray(err_j["w"][i]), rtol=1e-7,
                                   atol=1e-6)


def test_int8_rounds_half_to_even_as_the_reference():
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5], np.float32)
    qt, _ = coll.quantize_int8(torch.from_numpy(x))
    qj, _ = jax_coll.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


@pytest.mark.parametrize("fn", ["all_gather_bytes", "reduce_scatter_bytes",
                                "all_reduce_bytes", "all_to_all_bytes"])
def test_ring_costs_equal_reference(fn):
    for nbytes in (100.0, 3.5e9):
        for k in (1, 2, 4, 16):
            assert getattr(coll, fn)(nbytes, k) == \
                getattr(jax_coll, fn)(nbytes, k)


# ---------------------------------------------------------------------------
# lm_loss and its gradients, per family
# ---------------------------------------------------------------------------
def _loss_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"embeds": rng.standard_normal((b, s, cfg.d_model),
                                              np.float32),
                "positions3": rng.integers(0, 16, (3, b, s)).astype(
                    np.int32),
                "labels": rng.integers(0, cfg.vocab, (b, s)).astype(
                    np.int32)}
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, s + 3, cfg.d_model),
                                              np.float32)
    return batch


# case -> (arch, batch, sequence)
LOSS_CASES = {"dense-one-chunk": ("smollm-135m", 2, 32),
              "dense-two-chunks": ("smollm-135m", 2, 1025),
              "moe": ("granite-moe-1b-a400m", 2, 32),
              "ssm": ("mamba2-2.7b", 2, 32),
              "hybrid": ("zamba2-2.7b", 2, 32),
              "vlm": ("qwen2-vl-2b", 2, 24),
              "encdec": ("whisper-small", 2, 20)}


def _jax_value_and_grad(cj, pj, batch, remat):
    _reset_reference_hooks()
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm_loss(p, cj, b, remat=remat)))
    loss, grads = fn(pj, _jnp(batch))
    return float(loss), _names(grads)


def _port_value_and_grad(ct, model, batch, remat):
    named = dict(model.named_parameters())
    loss = lm_loss(model, ct, _pt(batch), remat=remat)
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), dict(zip(named, grads))


@pytest.fixture(scope="module")
def loss_refs():
    """case -> (port cfg, port model, batch, reference loss, reference
    grads by port name), the reference at remat "none"."""
    out = {}
    for case, (arch, b, s) in LOSS_CASES.items():
        cj, pj, ct, model = _build(arch)
        batch = _loss_batch(ct, b, s, seed=len(out))
        out[case] = (ct, model, batch) + _jax_value_and_grad(cj, pj, batch,
                                                             "none")
    return out


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_lm_loss_and_grads_match_reference(loss_refs, case):
    ct, model, batch, loss_j, grads_j = loss_refs[case]
    loss_t, grads_t = _port_value_and_grad(ct, model, batch, "none")
    assert loss_t == pytest.approx(loss_j, rel=LOSS_TOL)
    _leafwise_close(grads_t, grads_j, GRAD_TOL)


@pytest.mark.parametrize("s,chunks", [(32, 1), (513, 1), (1025, 2),
                                      (1537, 3), (1026, 1)])
def test_lm_loss_chunks_as_the_reference(monkeypatch, s, chunks):
    """Chunked only when S-1 is a multiple of CE_CHUNK larger than it, each
    chunk under torch.utils.checkpoint (S = 2048: one piece)."""
    from repro_torch.models import model as model_mod
    calls = []
    real = model_mod.checkpoint
    monkeypatch.setattr(model_mod, "checkpoint",
                        lambda fn, *a, **kw: calls.append(fn) or real(
                            fn, *a, **kw))
    ct = reduced_config("smollm-135m")
    m = init_model(ct, device="cpu")
    lm_loss(m, ct, {"tokens": torch.zeros(1, s, dtype=torch.long)},
            remat="none")
    n_ckpt = len([f for f in calls if f is model_mod._chunk_nll])
    assert n_ckpt == (chunks if chunks > 1 else 0)
    assert (2047 % model_mod.CE_CHUNK != 0)


def test_tied_head_gets_both_gradients():
    """With tied embeddings the gradient of `embed` is the lookup's plus
    the head's: equal to an untied copy's `embed` gradient plus its
    `lm_head` gradient, transposed."""
    ct = reduced_config("smollm-135m")
    assert ct.tie_embeddings
    tied = init_model(ct, torch.Generator().manual_seed(1), device="cpu")
    cu = dataclasses.replace(ct, tie_embeddings=False)
    untied = init_model(cu, device="cpu")
    with torch.no_grad():
        for n, p in tied.named_parameters():
            dict(untied.named_parameters())[n].copy_(p)
        untied.lm_head.copy_(tied.embed.T)
    batch = _pt(_loss_batch(ct, 2, 16, seed=5))
    g_tied = torch.autograd.grad(lm_loss(tied, ct, batch), tied.embed)[0]
    ge, gh = torch.autograd.grad(lm_loss(untied, cu, batch),
                                 [untied.embed, untied.lm_head])
    assert float(gh.abs().max()) > 0 and float(ge.abs().max()) > 0
    torch.testing.assert_close(g_tied, ge + gh.T, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------
REMAT_CASES = ["dense-one-chunk", "moe", "ssm", "encdec"]


@pytest.mark.parametrize("remat", sorted(REMAT_POLICIES))
@pytest.mark.parametrize("case", REMAT_CASES)
def test_remat_modes_equal_none(loss_refs, case, remat):
    ct, model, batch, _, _ = loss_refs[case]
    loss_n, grads_n = _port_value_and_grad(ct, model, batch, "none")
    loss_r, grads_r = _port_value_and_grad(ct, model, batch, remat)
    assert loss_r == pytest.approx(loss_n, rel=1e-6)
    _leafwise_close(grads_r, {k: _np(v) for k, v in grads_n.items()}, 1e-6)


def test_dots_no_batch_matches_reference(loss_refs):
    arch, b, s = LOSS_CASES["dense-one-chunk"]
    cj, pj, ct, model = _build(arch)
    batch = _loss_batch(ct, b, s, seed=9)
    loss_j, grads_j = _jax_value_and_grad(cj, pj, batch, "dots_no_batch")
    loss_t, grads_t = _port_value_and_grad(ct, model, batch, "dots_no_batch")
    assert loss_t == pytest.approx(loss_j, rel=LOSS_TOL)
    _leafwise_close(grads_t, grads_j, GRAD_TOL)


@pytest.mark.parametrize("remat", ["full", "dots", "dots_no_batch"])
def test_remat_policies_save_the_products_they_name(remat):
    """Which outputs a block's checkpoint keeps, by the policy's decision
    per op of one dense block: "full" none; "dots" every product;
    "dots_no_batch" mm and the batch-1 bmm of the projection einsums, not
    the attention's batched products."""
    from torch.utils.checkpoint import CheckpointPolicy
    from repro_torch.models import model as model_mod
    ct = reduced_config("smollm-135m")
    m = init_model(ct, device="cpu")
    seen = []
    factory = REMAT_POLICIES[remat]
    if remat == "full":
        assert factory is torch.utils.checkpoint.noop_context_fn
        return
    policy = factory.args[0]

    def spy(ctx, op, *args, **kw):
        out = policy(ctx, op, *args, **kw)
        if out == CheckpointPolicy.MUST_SAVE:
            seen.append((op.__name__.split(".")[0],
                         args[0].shape[0] if op.__name__.startswith("bmm")
                         else None))
        return out

    def ctx():
        return torch.utils.checkpoint.create_selective_checkpoint_contexts(
            spy)

    x = torch.randn(2, 8, ct.d_model, requires_grad=True)
    pos = torch.arange(8)[None].expand(2, 8)
    torch.utils.checkpoint.checkpoint(
        model_mod._attn_block_fwd, m.layers[0], ct, x, pos, moe=False,
        use_reentrant=False, context_fn=ctx).sum().backward()
    assert {k for k, _ in seen} == {"mm", "bmm"}
    batched = [n for k, n in seen if k == "bmm" and n != 1]
    assert bool(batched) == (remat == "dots")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
TRAIN_ARCH = "smollm-135m"


def _train_batch(cfg, seed=1, b=4, s=32):
    return {"tokens": np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)}


def _run_steps(n_steps, mb, compression=False, seed=0):
    """-> per step [(loss, grad_norm, lr)] and the final params, for the
    reference (jitted) and the port, from the same params and batches."""
    cj, pj, ct, model = _build(TRAIN_ARCH, seed=seed)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    tcfg = dict(remat="none", microbatches=mb, grad_compression=compression)
    _reset_reference_hooks()
    step_j = jax.jit(jax_ts.make_train_step(cj, jax_opt.OptConfig(**ocfg),
                                            jax_ts.TrainConfig(**tcfg)))
    step_t = ts.make_train_step(ct, opt.OptConfig(**ocfg),
                                ts.TrainConfig(**tcfg))
    sj = jax_ts.TrainState(pj, jax_opt.init_opt_state(
        jax_opt.OptConfig(**ocfg), pj),
        jax_coll.init_error_state(pj) if compression else None)
    st = ts.TrainState(model, opt.init_opt_state(opt.OptConfig(**ocfg),
                                                 model),
                       coll.init_error_state(model) if compression else None)
    out_j, out_t = [], []
    for i in range(n_steps):
        batch = _train_batch(ct, seed=100 + i)
        sj, mj = step_j(sj, _jnp(batch))
        st, mt = step_t(st, _pt(batch))
        out_j.append((float(mj["loss"]), float(mj["grad_norm"]),
                      float(mj["lr"])))
        out_t.append((float(mt["loss"]), float(mt["grad_norm"]), mt["lr"]))
    return out_j, out_t, sj, st


@pytest.mark.parametrize("mb", [1, 2, 4])
def test_train_steps_match_reference(mb):
    out_j, out_t, sj, st = _run_steps(3, mb)
    for (lj, gj, rj), (lt, gt, rt) in zip(out_j, out_t):
        assert lt == pytest.approx(lj, rel=LOSS_TOL)
        assert gt == pytest.approx(gj, rel=LOSS_TOL)
        assert rt == pytest.approx(rj, rel=1e-6)
    want = _names(sj.params)
    got = dict(st.params.named_parameters())
    for n, w in want.items():
        np.testing.assert_allclose(_np(got[n]), w, rtol=0,
                                   atol=STEP_LR_TOL * 1e-3 * 3)
    assert st.opt.step == int(sj.opt.step) == 3


def test_grad_compression_step_matches_reference():
    out_j, out_t, sj, st = _run_steps(3, 1, compression=True)
    for (lj, gj, _), (lt, gt, _) in zip(out_j, out_t):
        assert lt == pytest.approx(lj, rel=LOSS_TOL)
        assert gt == pytest.approx(gj, rel=LOSS_TOL)
    # the residual is at most half a quantum: the gradients' float32
    # rounding (~1e-6 of a gradient) is ~1e-4 of it, a flipped int8 code
    # a whole quantum (2x the largest residual)
    err_j = _names(sj.compress_err)
    _leafwise_close(st.compress_err, err_j, 1e-3)
    assert any(float(e.abs().max()) > 0 for e in st.compress_err.values())


def test_microbatch_contract_holds_on_the_port():
    """The reference's test_microbatched_grads_match_full_batch, on the
    port: one step at microbatches 1, 2 and 4 from one state."""
    ct = reduced_config(TRAIN_ARCH)
    gen_batch = _train_batch(ct, seed=7)
    outs = []
    for mb in (1, 2, 4):
        model = init_model(ct, torch.Generator().manual_seed(0),
                           device="cpu")
        st = ts.TrainState(model, opt.init_opt_state(opt.OptConfig(),
                                                     model))
        step = ts.make_train_step(ct, opt.OptConfig(),
                                  ts.TrainConfig(remat="none",
                                                 microbatches=mb))
        st, m = step(st, _pt(gen_batch))
        outs.append((float(m["loss"]), dict(model.named_parameters())))
    l1, p1 = outs[0]
    for loss, p in outs[1:]:
        assert abs(loss - l1) / abs(l1) < 1e-3
        d = max(float((p1[n] - p[n]).detach().abs().max())
                for n in p1)
        assert d < 5e-3, d


def test_microbatch_grads_accumulate_in_float32():
    """bf16 params: the accumulated gradients are float32, equal to the
    mean of each microbatch's bf16 gradient added in float32 (not summed
    in bf16)."""
    ct = dataclasses.replace(reduced_config(TRAIN_ARCH),
                             param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    model = init_model(ct, torch.Generator().manual_seed(0), device="cpu")
    batch = _pt(_train_batch(ct, seed=8))
    tc = ts.TrainConfig(remat="none", microbatches=4)
    loss, grads = ts.loss_and_grads(ct, tc, model, batch)
    assert all(g.dtype == torch.float32 for g in grads.values())
    named = dict(model.named_parameters())
    want = {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in named.items()}
    losses = []
    for mb in ts._split_microbatches(batch, 4):
        lm = lm_loss(model, ct, mb, remat="none")
        losses.append(lm.detach())
        for n, g in zip(named, torch.autograd.grad(lm, list(
                named.values()))):
            assert g.dtype == torch.bfloat16
            want[n] += g.float()
    for n in named:
        torch.testing.assert_close(grads[n], want[n] / 4, rtol=0, atol=0)
    assert float(loss) == pytest.approx(float(sum(losses)) / 4, rel=1e-6)


def test_split_microbatches_matches_reference():
    rng = np.random.default_rng(4)
    batch = {"embeds": rng.standard_normal((4, 6, 8)).astype(np.float32),
             "positions3": rng.integers(0, 9, (3, 4, 6)).astype(np.int32),
             "labels": rng.integers(0, 9, (4, 6)).astype(np.int32)}
    want = jax_ts._split_microbatches(_jnp(batch), 2)
    got = ts._split_microbatches(_pt(batch), 2)
    assert len(got) == 2
    for i in range(2):
        for k in batch:
            np.testing.assert_array_equal(got[i][k].numpy(),
                                          np.asarray(want[k][i]))
    with pytest.raises(ValueError, match="cannot split"):
        ts._split_microbatches({"tokens": torch.zeros(3, 4)}, 2)


# ---------------------------------------------------------------------------
# checkpoint and resilience
# ---------------------------------------------------------------------------
def _bf16_state(seed=0, compression=False):
    ct = dataclasses.replace(reduced_config(TRAIN_ARCH),
                             param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    model = init_model(ct, torch.Generator().manual_seed(seed),
                       device="cpu")
    state = ts.TrainState(model, opt.init_opt_state(opt.OptConfig(), model),
                          coll.init_error_state(model) if compression
                          else None)
    return ct, state


def test_checkpoint_roundtrip_bf16_state(tmp_path):
    """A state after two steps (bf16 params, float32 master, m, v, the
    error state, the step) restores bit-equal into a fresh state."""
    ct, state = _bf16_state(compression=True)
    step = ts.make_train_step(ct, opt.OptConfig(),
                              ts.TrainConfig(remat="none",
                                             grad_compression=True))
    for i in range(2):
        state, _ = step(state, _pt(_train_batch(ct, seed=i)))
    leaves = state.leaves()
    assert {k.split("/")[0] for k in leaves} == {"params", "opt",
                                                 "compress_err"}
    assert leaves["params/embed"].dtype == torch.bfloat16
    ckpt.save(str(tmp_path), 2, leaves)
    assert ckpt.latest_step(str(tmp_path)) == 2
    _, fresh = _bf16_state(seed=1, compression=True)
    fresh.load_leaves(ckpt.restore(str(tmp_path), 2, fresh.leaves()))
    assert fresh.opt.step == 2
    got = fresh.leaves()
    for k, v in leaves.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k


def test_checkpoint_layout_matches_reference(tmp_path):
    """The same files as the reference's save: step_<N>/meta.json with the
    same keys, shard_<host>.npz, LATEST; no temporary names left."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.ones(4, np.float32)}
    ckpt.save(str(tmp_path / "t"), 7, _pt(tree), extra={"x": 1}, host_id=2)
    jax_ckpt.save(str(tmp_path / "j"), 7, tree, extra={"x": 1}, host_id=2)
    for root in ("t", "j"):
        assert sorted(os.listdir(tmp_path / root)) == ["LATEST", "step_7"]
        assert sorted(os.listdir(tmp_path / root / "step_7")) == [
            "meta.json", "shard_2.npz"]
    meta = [json.loads((tmp_path / r / "step_7" / "meta.json").read_text())
            for r in ("t", "j")]
    assert meta[0] == meta[1] == {"step": 7, "n_leaves": 2,
                                  "extra": {"x": 1}}
    with np.load(tmp_path / "t" / "step_7" / "shard_2.npz") as data:
        np.testing.assert_array_equal(data["a"], tree["a"])


def test_async_checkpointer_keeps_three(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    tree = {"x": torch.ones(3)}
    for s in (1, 2, 3, 4, 5):
        tree["x"] += 1
        saver.save_async(s, tree)
    saver.wait()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_3", "step_4", "step_5"]
    assert ckpt.latest_step(str(tmp_path)) == 5
    out = ckpt.restore(str(tmp_path), 3, {"x": torch.zeros(3)})
    assert out["x"].tolist() == [4.0, 4.0, 4.0]   # copied at save time


def test_restore_raises_on_missing_leaf_and_shape(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(2, 3)})
    with pytest.raises(KeyError, match="missing leaves"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(2, 3),
                                        "b": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(3, 2)})
    assert ckpt.latest_step(str(tmp_path / "none")) is None


RESILIENCE = [jax_resilience, resilience]


@pytest.mark.parametrize("mod", RESILIENCE, ids=["reference", "port"])
def test_plan_remesh_keeps_tp_and_batch_divisibility(mod):
    plan = mod.plan_remesh(60, model_parallel=16, global_batch=256)
    assert plan.mesh_shape == (2, 16)
    assert plan.dropped_devices == 28
    plan2 = mod.plan_remesh(64, model_parallel=16, global_batch=256)
    assert plan2.mesh_shape == (4, 16) and plan2.dropped_devices == 0
    plan3 = mod.plan_remesh(64, model_parallel=4, global_batch=64,
                            prefer_pods=2)
    assert plan3.mesh_shape == (2, 8, 4)
    assert plan3.axis_names == ("pod", "data", "model")
    with pytest.raises(RuntimeError):
        mod.plan_remesh(8, model_parallel=16, global_batch=256)


@pytest.mark.parametrize("mod", RESILIENCE, ids=["reference", "port"])
def test_straggler_monitor_flags_slow_host(mod):
    mon = mod.StragglerMonitor(n_hosts=4, warmup=3)
    mon.record([1.0, 1.0, 1.0, 2.5])
    assert mon.stragglers() == []              # inside the warmup
    for _ in range(9):
        mon.record([1.0, 1.0, 1.0, 2.5])
    assert mon.stragglers() == [3]
    assert mon.healthy_hosts() == [0, 1, 2]


@pytest.mark.parametrize("mod", RESILIENCE, ids=["reference", "port"])
def test_failure_policy_escalates(mod):
    pol = mod.FailurePolicy(max_retries=2)
    assert pol.on_failure(5, 0) == "retry"
    assert pol.on_failure(5, 2) == "restore_and_remesh"


def test_resilience_port_equals_reference():
    for n in (7, 16, 60, 64, 100):
        for mp in (1, 4, 8):
            if n < mp:
                continue
            a = resilience.plan_remesh(n, model_parallel=mp,
                                       global_batch=96, prefer_pods=2)
            b = jax_resilience.plan_remesh(n, model_parallel=mp,
                                           global_batch=96, prefer_pods=2)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------------------
# train_loop and the entry point
# ---------------------------------------------------------------------------
def test_train_loop_trains_checkpoints_and_resumes(tmp_path, capsys):
    """The contract of the reference's test_train_loop_end_to_end (which
    the reference cannot run on this JAX), on the port."""
    losses = launch_train.train_loop(
        arch="smollm-135m", steps=16, seq_len=32, global_batch=4,
        reduced=True, ckpt_dir=str(tmp_path), log_every=50, device="cpu")
    assert len(losses) == 16
    assert losses[-1] < losses[0]
    assert ckpt.latest_step(str(tmp_path)) == 16
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_10", "step_16"]
    more = launch_train.train_loop(
        arch="smollm-135m", steps=20, seq_len=32, global_batch=4,
        reduced=True, ckpt_dir=str(tmp_path), log_every=50, device="cpu")
    assert len(more) == 4
    assert "[train] resumed from step 16" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 20


def test_main_lm_serves_a_trained_checkpoint(tmp_path, capsys,
                                             monkeypatch):
    """`launch.serve lm --ckpt-dir` serves the parameters `train_loop`
    checkpointed: the engine's model equals the trained one."""
    from repro_torch.launch.serve import main_lm
    launch_train.train_loop(arch="smollm-135m", steps=2, seq_len=16,
                            global_batch=2, ckpt_dir=str(tmp_path),
                            log_every=50, device="cpu")
    leaves = ckpt.restore(str(tmp_path), 2, {"params/embed": torch.zeros(
        reduced_config("smollm-135m").vocab, 64)})
    seen = []
    import repro_torch.serve.engine as engine_mod
    real = engine_mod.ServeEngine.__init__

    def spy(self, cfg, params, **kw):
        seen.append(params.embed.detach().clone())
        real(self, cfg, params, **kw)

    monkeypatch.setattr(engine_mod.ServeEngine, "__init__", spy)
    main_lm(["--device", "cpu", "--ckpt-dir", str(tmp_path),
             "--requests", "2", "--max-new-tokens", "2"])
    assert "[serve] restored params from step 2" in capsys.readouterr().out
    assert torch.equal(seen[0], leaves["params/embed"])


LOOP_STEPS = 6


def _reference_loop(arch, steps, seq_len, global_batch, mb):
    """The reference's train loop from its pieces (`init_model`,
    `init_opt_state`, `make_train_step` under jax.jit, no mesh) ->
    (losses, initial params)."""
    cj = jax_reduced_config(arch)
    ocfg = jax_opt.OptConfig(lr=3e-4, warmup_steps=max(steps // 20, 5),
                             total_steps=steps)
    data = jax_pipeline.make_source(jax_pipeline.DataConfig(
        seq_len=seq_len, global_batch=global_batch, vocab=cj.vocab))
    params, _ = jax_init_model(cj, jax.random.PRNGKey(0))
    _reset_reference_hooks()
    step = jax.jit(jax_ts.make_train_step(
        cj, ocfg, jax_ts.TrainConfig(remat="none", microbatches=mb)))
    state = jax_ts.TrainState(params, jax_opt.init_opt_state(ocfg, params),
                              None)
    losses = []
    for i in range(steps):
        state, m = step(state, _jnp(data.batch(i)))
        losses.append(float(m["loss"]))
    return losses, params


def _port_loop(arch, steps, seq_len, global_batch, mb, params_tree=None):
    """The same loop from the port's pieces; params from the port's
    `init_model` (CPU generator seeded with 0, as `train_loop` draws
    them), or `params_tree` (a reference tree) loaded into it."""
    ct = reduced_config(arch)
    ocfg = opt.OptConfig(lr=3e-4, warmup_steps=max(steps // 20, 5),
                         total_steps=steps)
    data = pipeline.make_source(pipeline.DataConfig(
        seq_len=seq_len, global_batch=global_batch, vocab=ct.vocab))
    model = init_model(ct, torch.Generator().manual_seed(0), device="cpu")
    if params_tree is not None:
        convert.load_model_params(model, jax.tree_util.tree_map(
            np.asarray, params_tree))
    step = ts.make_train_step(ct, ocfg, ts.TrainConfig(remat="none",
                                                       microbatches=mb))
    state = ts.TrainState(model, opt.init_opt_state(ocfg, model))
    losses = []
    for i in range(steps):
        state, m = step(state, _pt(data.batch(i)))
        losses.append(float(m["loss"]))
    return losses


def test_port_loop_equals_reference_loop():
    want, params = _reference_loop("smollm-135m", LOOP_STEPS, 32, 4, 2)
    got = _port_loop("smollm-135m", LOOP_STEPS, 32, 4, 2, params)
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)


def test_train_loop_equals_the_port_pieces():
    got = launch_train.train_loop(arch="smollm-135m", steps=LOOP_STEPS,
                                  seq_len=32, global_batch=4,
                                  microbatches=2, log_every=50,
                                  device="cpu")
    assert got == _port_loop("smollm-135m", LOOP_STEPS, 32, 4, 2)


def test_train_loop_one_device_only():
    with pytest.raises(NotImplementedError, match="item 9"):
        launch_train.train_loop(arch="smollm-135m", steps=1, seq_len=8,
                                global_batch=2, mesh_shape=(2, 1),
                                device="cpu")


def test_train_main_runs_on_the_cpu():
    """`python -m repro_torch.launch.train --device cpu --steps 4`."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device",
         "cpu", "--steps", "4"], capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("[train] step") == 2      # steps 0 and 3
    assert "[train] loss" in proc.stdout


def test_train_main_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("host has a CUDA device: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--steps", "1"])
