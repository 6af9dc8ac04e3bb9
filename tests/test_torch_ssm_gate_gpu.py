"""The port's CUDA kernel for Mamba2's gate chain (`kernels/ssm_gate`)
against its plain PyTorch version (`ref.gate_chain`), and the Mamba2 model
through it, on the card.

Needs an NVIDIA GPU of compute capability 9.0 and nvcc, so every test here
is marked `gpu` and skips on a host without one.  The file imports nothing
of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssm_gate_gpu.py

Tolerances.  The kernel rounds where the eager chain rounds, so its gated
values equal the chain's; only the order of the float32 sum of squares
differs from ATen's reduction, which moves the row's scale by a few float32
ulps.  In bf16 that can flip the output's last rounding: at most one bf16
ulp of the eager output.  In float32: 1e-5 relative.  The whole model in
float32 against the same model on the eager chain: `chip_smoke.py`'s
LOGIT_TOL_F32."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssm_conv import ops as conv_ops
from repro_torch.kernels.ssm_gate import kernel, ops, ref
from repro_torch.models import forward, init_model

TOL_F32 = 1e-5
LOGIT_TOL_F32 = 2e-3       # chip_smoke.py's: max |a - b| <= tol * max |b|
EPS = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA GPU of compute capability 9.0")
    return torch.device("cuda", 0)


def _model_views(bsz, t, h, p, gn, dev, dtype=torch.bfloat16, seed=0):
    """(y, xh, D, z, out_norm) as `mamba2_forward` hands them over: in_proj's
    output of unit scale through the conv kernel (z its view, xh the first
    H P columns of the float32 conv output) and the SSD kernel (y), at the
    model's scales of conv_w, A and dt.  Where the SSD op takes no such
    shape (T not a multiple of its chunk of 128, P or N outside its
    sizes), y is a contiguous float32 tensor of unit scale."""
    rng = np.random.default_rng(seed)
    di = h * p

    def r(*s, scale=1.0, shift=0.0):
        v = rng.standard_normal(s).astype(np.float32) * scale + shift
        return torch.from_numpy(v).to(dev)

    zxbcdt = r(bsz, t, 2 * di + 2 * gn + h).to(dtype)
    with torch.no_grad():
        z, conv32, dt = conv_ops.ssm_conv(
            zxbcdt, r(4, di + 2 * gn, scale=0.5).to(dtype),
            r(di + 2 * gn, scale=0.1).to(dtype),
            r(h, scale=0.5, shift=-4.6).to(dtype), d_inner=di, gn=gn)
        xh = conv32[..., :di].unflatten(-1, (h, p))
        bh = conv32[..., di:di + gn].unflatten(-1, (1, gn))
        ch = conv32[..., di + gn:].unflatten(-1, (1, gn))
        a = -torch.linspace(1.0, 16.0, h, device=dev)
        if t % 128 == 0 and p in (8, 16, 32, 64) and 16 <= gn <= 128:
            y = ssd_ops.ssd_scan(xh, dt, a, bh, ch, chunk=128)
        else:
            y = r(bsz, t, h, p)
    return (y, xh, (1 + 0.5 * r(h)).to(dtype), z,
            (1 + 0.1 * r(di)).to(dtype))


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def _check(args, dtype):
    before = kernel.LAUNCHES["fused"]
    with torch.no_grad():
        got = ops.ssm_gate(*args, eps=EPS, dtype=dtype)
        want = ref.gate_chain(*args, EPS, dtype)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["fused"] == before + 1
    b, t, h, p = args[0].shape
    assert got.shape == (b, t, h * p) and got.dtype == dtype
    assert got.is_contiguous()
    if dtype == torch.bfloat16:
        err = (got.float() - want.float()).abs()
        ulp = _bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
        assert bool((err <= ulp).all()), float((err / ulp).max())
    else:
        torch.testing.assert_close(got, want, rtol=TOL_F32, atol=TOL_F32)
    return got


# mamba2-2.7b's layer (80 heads of 64, G N 128) at [4, 2048] and
# granite-4.0-h-small's (128 heads of 64) at [2, 4096], on the views the
# conv and SSD kernels give
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bsz,t,h", [(4, 2048, 80), (2, 4096, 128)],
                         ids=["mamba2", "granite"])
def test_kernel_at_the_models_layers(card, bsz, t, h, dtype):
    args = _model_views(bsz, t, h, 64, 128, card, dtype=dtype)
    assert kernel.vector_ok(*args[:2], args[3], args[4])
    _check(args, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,t,h,p,gn,dtype", [
    (3, 1, 80, 64, 128, torch.bfloat16),      # T = 1
    (3, 7, 80, 64, 128, torch.bfloat16),      # odd B T
    (2, 128, 2, 64, 16, torch.bfloat16),      # heads of 64, H 2: z copied
    (2, 128, 2, 64, 16, torch.float32),
    (1, 128, 8, 16, 16, torch.bfloat16),      # the reduced models' layer
    (1, 128, 5, 8, 16, torch.float32),        # d_inner 40, P 8
    (2, 7, 5, 8, 16, torch.bfloat16),         # z rows of 234 B: copied
    (2, 7, 5, 8, 16, torch.float32),
    (2, 16, 160, 64, 128, torch.bfloat16),    # 2 chunks a thread
    (1, 9, 256, 64, 128, torch.float32),      # d_inner 16384: one stage
])
def test_kernel_on_ragged_shapes(card, bsz, t, h, p, gn, dtype):
    _check(_model_views(bsz, t, h, p, gn, card, dtype=dtype), dtype)


@pytest.mark.gpu
def test_a_copied_input_equals_the_one_read_in_place(card):
    """z in a buffer that starts one element in (the wrapper hands the
    kernel a contiguous copy, at odd B T = 21): bit-equal to the aligned
    input's result, which the kernel reads in place."""
    args = _model_views(3, 7, 80, 64, 128, card)
    z = args[3]
    off = torch.zeros(z.numel() + 1, dtype=z.dtype, device=card)[1:]
    off = off.view(z.shape)
    off.copy_(z)
    assert kernel.vector_ok(*args[:2], z, args[4])
    assert not kernel.vector_ok(*args[:2], off, args[4])
    with torch.no_grad():
        want = ops.ssm_gate(*args, eps=EPS, dtype=torch.bfloat16)
        got = ops.ssm_gate(*args[:3], off, args[4], eps=EPS,
                           dtype=torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_each_row_is_normalised_alone(card):
    """Row (b, t) of a batch equals the same row run alone, bit for bit."""
    args = _model_views(2, 64, 80, 64, 128, card)
    with torch.no_grad():
        out = ops.ssm_gate(*args, eps=EPS, dtype=torch.bfloat16)
        for b, t in ((0, 0), (1, 63), (1, 17)):
            alone = ops.ssm_gate(
                *(v[b:b + 1, t:t + 1] for v in args[:2]), args[2],
                args[3][b:b + 1, t:t + 1], args[4], eps=EPS,
                dtype=torch.bfloat16)
            assert torch.equal(out[b:b + 1, t:t + 1], alone)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(card):
    y, xh, D, z, w = _model_views(1, 128, 2, 64, 16, card)
    before = dict(kernel.LAUNCHES)
    with pytest.raises(ValueError, match="one type"):
        ops.ssm_gate(y, xh, D.half(), z.half(), w.half(), eps=EPS,
                     dtype=torch.float16)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.ssm_gate(y.unflatten(-1, (16, 4)).flatten(2, 3),
                     xh.unflatten(-1, (16, 4)).flatten(2, 3),
                     D.repeat_interleave(16), z, w, eps=EPS,
                     dtype=torch.bfloat16)
    w.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernel.ssm_gate_fwd(y, xh, D, z, w, eps=EPS, dtype=torch.bfloat16)
    got = ops.ssm_gate(y, xh, D, z, w, eps=EPS, dtype=torch.bfloat16)
    assert got.requires_grad and torch.equal(    # the plain chain
        got, ref.gate_chain(y, xh, D, z, w, EPS, torch.bfloat16))
    assert kernel.LAUNCHES == before


@pytest.mark.gpu
def test_a_card_dtensor_runs_the_kernel_on_local_shards(card):
    """On a (1, 1) mesh (NCCL, a world of one): y and xh sharded on batch,
    and on batch and heads (replicated first), launch the kernel once on
    the local tensors; the DTensor's local value equals the plain
    tensors' result bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_mesh
    args = _model_views(2, 128, 80, 64, 128, card)
    with torch.no_grad():
        want = ops.ssm_gate(*args, eps=EPS, dtype=torch.bfloat16)
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    try:
        for placements in ([Shard(0), Replicate()], [Shard(0), Shard(2)]):
            dargs = [DTensor.from_local(v, mesh, placements)
                     for v in args[:2]] + [
                DTensor.from_local(args[2], mesh, [Replicate(), Shard(0)]),
                DTensor.from_local(args[3], mesh, [Shard(0), Replicate()]),
                args[4]]
            before = kernel.LAUNCHES["fused"]
            with torch.no_grad():
                got = ops.ssm_gate(*dargs, eps=EPS, dtype=torch.bfloat16)
            torch.cuda.synchronize()
            assert kernel.LAUNCHES["fused"] == before + 1
            assert isinstance(got, DTensor)
            assert tuple(got.placements) == (Shard(0), Replicate())
            assert torch.equal(got.to_local(), want)
    finally:
        dist.destroy_process_group()


def _on_the_eager_chain(fn):
    real = ops.ssm_gate
    ops.ssm_gate = lambda y, xh, D, z, w, *, eps, dtype: ref.gate_chain(
        y, xh, D, z, w, eps, dtype)
    try:
        return fn()
    finally:
        ops.ssm_gate = real


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_model_prefill_launches_the_kernel_once_a_layer(card, arch):
    """The reduced bf16 model's prefill on the card: one launch a Mamba2
    layer, and logits within the bf16 tolerance of the same model on the
    eager chain."""
    cfg = dataclasses.replace(reduced_config(arch), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = init_model(cfg, torch.Generator(card).manual_seed(0),
                       device=card)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (3, 64))).to(card)
    n_mamba = sum(1 for blk in model.layers if hasattr(blk, "ssm"))
    with torch.no_grad():
        before = kernel.LAUNCHES["fused"]
        got = forward(model, cfg, {"tokens": tokens}).float()
        torch.cuda.synchronize()
        assert n_mamba > 0
        assert kernel.LAUNCHES["fused"] == before + n_mamba
        want = _on_the_eager_chain(lambda: forward(
            model, cfg, {"tokens": tokens}).float())
    assert float((got - want).abs().max()) <= 5e-2 * float(want.abs().max())


@pytest.mark.gpu
def test_full_mamba2_on_the_kernel_matches_the_eager_chain(card):
    """mamba2-2.7b at full width and depth, weights cast to float32: the
    prefill at a short shape launches the kernel once a layer (64) and its
    logits lie within LOGIT_TOL_F32 of the same prefill on the eager
    chain."""
    cfg = get_config("mamba2-2.7b")
    model = init_model(cfg, torch.Generator(card).manual_seed(0),
                       device=card).float()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 256))).to(card)
    run = lambda: forward(model, cfg32, {"tokens": tokens},  # noqa: E731
                          logits_mode="last")
    with torch.no_grad():
        before = kernel.LAUNCHES["fused"]
        got = run()
        assert kernel.LAUNCHES["fused"] == before + cfg.n_layers == \
            before + 64
        want = _on_the_eager_chain(run)
    err = float((got - want).abs().max())
    assert err <= LOGIT_TOL_F32 * float(want.abs().max()), err
    del model
    torch.cuda.empty_cache()
