"""The training path on the card, at reduced configs (2 layers, d_model
64, bf16 params with float32 master copies):

  * one step at microbatches 1 and 2 from one state: loss within 1e-3
    relative and params within 5e-3 (the reference's microbatch contract);
  * remat "none", "full", "dots" and "dots_no_batch" give the same loss
    within 1e-3 relative;
  * a state saved and restored is bit-equal leaf by leaf, and its next
    step's loss is the live state's within 1e-3 relative (CUDA's
    embedding backward adds with atomics);
  * Mamba2 trains on the model's scan (no SSD launch), and in float32 its
    `lm_loss` on the SSD kernel (under no_grad) equals the scan's (under
    autograd) within 2e-4 relative, the SSD kernel's tolerance;
  * both kernel wrappers raise under autograd;
  * `train_loop` trains, checkpoints and resumes on the card.

Needs an NVIDIA GPU of compute capability 9.0 and nvcc; every test is
marked `gpu` and skips without one.  Imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.train import train_loop
from repro_torch.models import REMAT_POLICIES, init_model, lm_loss
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import (TrainConfig, TrainState,
                                          make_train_step)

LOSS_RTOL, PARAM_TOL, SSD_TOL = 1e-3, 5e-3, 2e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA GPU of compute capability 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version's
    return torch.device("cuda", 0)


def _bf16(arch):
    return dataclasses.replace(reduced_config(arch), param_dtype="bfloat16",
                               compute_dtype="bfloat16")


def _state(cfg, dev, seed=0):
    model = init_model(cfg, torch.Generator().manual_seed(seed), device=dev)
    return TrainState(model, init_opt_state(OptConfig(), model))


def _batch(cfg, dev, seed=0, b=4, s=64):
    return {"tokens": torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s))).to(dev)}


def _clone(state):
    return TrainState(copy.deepcopy(state.params), copy.deepcopy(state.opt))


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.gpu
def test_microbatches_match_on_the_card(card):
    cfg = _bf16("smollm-135m")
    base = _state(cfg, card)
    out = []
    for mb in (1, 2):
        st = _clone(base)
        st, m = make_train_step(cfg, OptConfig(), TrainConfig(
            microbatches=mb))(st, _batch(cfg, card))
        out.append((float(m["loss"]), st))
    (l1, s1), (l2, s2) = out
    assert _rel(l2, l1) < LOSS_RTOL
    with torch.no_grad():
        d = max(float((a - b).abs().max()) for a, b in zip(
            s1.params.parameters(), s2.params.parameters()))
    assert d < PARAM_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("remat", sorted(REMAT_POLICIES))
def test_remat_modes_give_the_same_loss(card, remat):
    cfg = _bf16("smollm-135m")
    base = _state(cfg, card)
    losses = {}
    for mode in ("none", remat):
        _, m = make_train_step(cfg, OptConfig(), TrainConfig(
            remat=mode, microbatches=2))(_clone(base), _batch(cfg, card))
        losses[mode] = float(m["loss"])
    assert _rel(losses[remat], losses["none"]) < LOSS_RTOL


@pytest.mark.gpu
def test_restored_state_is_bit_equal_and_trains_alike(card, tmp_path):
    cfg = _bf16("smollm-135m")
    step = make_train_step(cfg, OptConfig(), TrainConfig())
    live, _ = step(_state(cfg, card), _batch(cfg, card))
    ckpt.save(str(tmp_path), 1, live.leaves())
    back = _state(cfg, card, seed=1)
    back.load_leaves(ckpt.restore(str(tmp_path), 1, back.leaves()))
    a, b = live.leaves(), back.leaves()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert back.opt.step == live.opt.step == 1
    assert b["params/embed"].dtype == torch.bfloat16
    _, m_live = step(live, _batch(cfg, card, seed=1))
    _, m_back = step(back, _batch(cfg, card, seed=1))
    assert _rel(float(m_back["loss"]), float(m_live["loss"])) < LOSS_RTOL


@pytest.mark.gpu
def test_mamba2_trains_on_its_scan_and_matches_the_kernel(card):
    cfg = _bf16("mamba2-2.7b")
    state = _state(cfg, card)
    batch = _batch(cfg, card, s=64)
    ssd_kernel.reset_launches()
    _, m = make_train_step(cfg, OptConfig(), TrainConfig())(state, batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert not any(ssd_kernel.LAUNCHES.values())
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    state.params.float()
    with torch.no_grad():
        on_kernel = float(lm_loss(state.params, cfg32, batch))
    assert ssd_kernel.LAUNCHES["ssd"] == cfg.n_layers
    on_scan = float(lm_loss(state.params, cfg32, batch).detach())
    assert ssd_kernel.LAUNCHES["ssd"] == cfg.n_layers
    assert _rel(on_kernel, on_scan) < SSD_TOL


@pytest.mark.gpu
def test_kernel_wrappers_raise_under_autograd(card):
    q = torch.randn(1, 64, 2, 64, device=card, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(RuntimeError, match="backward"):
        flash_ops.flash_attention(q, q, q)
    xh = torch.randn(1, 64, 2, 16, device=card, requires_grad=True)
    dt = torch.rand(1, 64, 2, device=card)
    a = -torch.ones(2, device=card)
    bc = torch.randn(1, 64, 1, 16, device=card)
    with pytest.raises(RuntimeError, match="backward"):
        ssd_ops.ssd_scan(xh, dt, a, bc, bc, chunk=16)


@pytest.mark.gpu
def test_train_loop_on_the_card(card, tmp_path):
    kw = dict(arch="smollm-135m", seq_len=64, global_batch=4,
              ckpt_dir=str(tmp_path), log_every=50, device="cuda")
    losses = train_loop(steps=12, **kw)
    assert len(losses) == 12 and losses[-1] < losses[0]
    assert len(train_loop(steps=14, **kw)) == 2
    assert ckpt.latest_step(str(tmp_path)) == 14
