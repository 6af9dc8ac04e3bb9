"""The sharded step builders on the card, on a (1, 1) `DeviceMesh` (NCCL,
a world of one), at reduced configs with head dim 64 (bf16 params with
float32 master copies):

  * a `build_train_step` step equals the plain `make_train_step` step from
    the same state and batch: loss and grad norm within 1e-3 relative,
    params within 5e-3 (the training tests' contract);
  * `build_prefill_step` with the flash hook launches the kernel once a
    layer, on the local shards, and its last logits equal the unsharded
    prefill's within 5e-2 of their range (the smoke test's LOGIT_TOL);
  * `build_decode_step` steps equal `decode_step`'s within the same bound.

Needs an NVIDIA GPU of compute capability 9.0 and nvcc; every test is
marked `gpu` and skips without one.  Imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_parallel_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import steps
from repro_torch.models import (attention, decode_step, forward, init_cache,
                                init_model)
from repro_torch.parallel.sharding import make_rules
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import (TrainConfig, TrainState,
                                          make_train_step)

LOSS_RTOL, PARAM_TOL, LOGIT_TOL = 1e-3, 5e-3, 5e-2


@pytest.fixture
def mesh():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA GPU of compute capability 9.0")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version's
    m = make_mesh((1, 1), ("data", "model"), device="cuda")
    yield m
    dist.destroy_process_group()


def _cfg(arch="smollm-135m"):
    return dataclasses.replace(reduced_config(arch), head_dim=64,
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")


def _model(cfg, seed=0):
    return init_model(cfg, torch.Generator().manual_seed(seed),
                      device="cuda")


def _close(got, want, tol=LOGIT_TOL):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.gpu
def test_train_step_on_the_mesh_equals_the_plain_step(mesh):
    cfg, opt = _cfg(), OptConfig()
    tc = TrainConfig(remat="none", microbatches=2)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 64))
    plain = _model(cfg)
    st = TrainState(plain, init_opt_state(opt, plain))
    st, m0 = make_train_step(cfg, opt, tc)(
        st, {"tokens": torch.from_numpy(toks).cuda()})
    fn, _, tp = steps.build_train_step(cfg, mesh, make_rules(mesh),
                                       ShapeSpec("t", 64, 4, "train"),
                                       opt_cfg=opt, tc=tc)
    sst = steps.init_sharded_state(
        steps.shard_params(_model(cfg), tp.params, mesh), opt, tc, mesh, tp)
    sst, m1 = fn(sst, {"tokens": toks})
    for key in ("loss", "grad_norm"):
        a, b = float(m1[key]), float(m0[key])
        assert abs(a - b) <= LOSS_RTOL * abs(b), (key, a, b)
    err = max(float((p.full_tensor().float() - q.float()).abs().max())
              for p, q in zip(sst.params.parameters(),
                              st.params.parameters()))
    assert err <= PARAM_TOL


@pytest.mark.gpu
def test_prefill_step_runs_flash_on_local_shards(mesh):
    cfg = _cfg()
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 128))).cuda()
    fn, _, (p_pl, _) = steps.build_prefill_step(
        cfg, mesh, make_rules(mesh), ShapeSpec("p", 128, 2, "prefill"))
    sharded = steps.shard_params(_model(cfg), p_pl, mesh)
    plain = _model(cfg)
    with torch.no_grad():
        flash_ops.install()
        try:
            flash_kernel.reset_launches()
            got = fn(sharded, {"tokens": toks}).full_tensor()
            torch.cuda.synchronize()
            assert flash_kernel.LAUNCHES["flash"] == cfg.n_layers
            assert flash_kernel.LAUNCHES["flash_wgmma"] == cfg.n_layers
            want = forward(plain, cfg, {"tokens": toks}, logits_mode="last")
        finally:
            attention.set_flash_impl(None)
    _close(got, want)


@pytest.mark.gpu
def test_decode_step_on_the_mesh_equals_decode_step(mesh):
    cfg, b, max_len = _cfg("granite-moe-1b-a400m"), 4, 32
    fn, _, (p_pl, c_pl, _) = steps.build_decode_step(
        cfg, mesh, make_rules(mesh), ShapeSpec("d", max_len, b, "decode"))
    sharded = steps.shard_params(_model(cfg), p_pl, mesh)
    plain = _model(cfg)
    cache = init_cache(cfg, b, max_len, device="cuda")
    s_cache = steps.place_tree(init_cache(cfg, b, max_len, device="cuda"),
                               c_pl, mesh)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (4, b))).cuda()
    for i in range(toks.shape[0]):
        with torch.no_grad():
            lg, s_cache = fn(sharded, s_cache, toks[i], i)
            ref, cache = decode_step(plain, cfg, cache, toks[i], i)
        _close(lg.full_tensor(), ref)
