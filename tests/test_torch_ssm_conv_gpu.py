"""The port's CUDA kernel for Mamba2's conv chain (`kernels/ssm_conv`)
against its plain PyTorch version (`ref.conv_chain`), and the Mamba2 model
through it, on the card.

Needs an NVIDIA GPU of compute capability 9.0 and nvcc, so every test here
is marked `gpu` and skips on a host without one.  The file imports nothing
of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssm_conv_gpu.py

Tolerances.  Against the chain run in float32 on float32 copies of the
same inputs: 1e-5, absolute and relative, since the kernel computes the
same sums in float32 (fused multiply-adds, `__expf` in the SiLU).
Against the eager chain in the inputs' bf16 (what the model ran before the
kernel): each of that chain's K products, K - 1 sums, the bias add and the
SiLU rounds to bf16 (unit roundoff u = 2**-8), each by at most u s, s =
sum_j |w_j x_j| + |b| the magnitude the sums work at, and the SiLU's slope
is at most 1.1: to first order at most 1.1 (2 K + 1) u s, 9.9 u s at K =
4; the test allows 12 u s + 1e-6.  The whole model in float32 against
the same model on the eager chain: `chip_smoke.py`'s LOGIT_TOL_F32."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.ssm_conv import kernel, ops, ref
from repro_torch.models import forward, init_model

TOL = 1e-5
U_BF16 = 2.0 ** -8
LOGIT_TOL_F32 = 2e-3       # chip_smoke.py's: max |a - b| <= tol * max |b|


@pytest.fixture
def card():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA GPU of compute capability 9.0")
    return torch.device("cuda", 0)


def _inputs(bsz, t, di, gn, h, dev, k=4, dtype=torch.bfloat16, seed=0):
    """zxbcdt of unit scale, conv_w at the model's scale K**-0.5, a small
    bias, dt_bias about log(expm1(0.01))."""
    rng = np.random.default_rng(seed)
    c = di + 2 * gn

    def z(*s, scale=1.0, shift=0.0):
        v = rng.standard_normal(s).astype(np.float32) * scale + shift
        return torch.from_numpy(v).to(dev, dtype)

    return (z(bsz, t, 2 * di + 2 * gn + h), z(k, c, scale=k ** -0.5),
            z(c, scale=0.1), z(h, scale=0.5, shift=-4.6))


def _float32_chain(zxbcdt, w, b, dtb, di, gn):
    return ref.conv_chain(zxbcdt.float(), w.float(), b.float(), dtb.float(),
                          di, gn)


def _scale(zxbcdt, w, b, di, gn):
    """s[b, t, c] = sum_j |w[j, c] x[b, t - K + 1 + j, c]| + |b[c]|."""
    x = ref.split_proj(zxbcdt.float(), di, gn)
    x = torch.cat(x[1:4], dim=-1).abs()
    k, t = w.shape[0], x.shape[1]
    full = torch.cat([x.new_zeros(x.shape[0], k - 1, x.shape[2]), x], 1)
    return sum(full[:, j:j + t] * w[j].float().abs() for j in range(k)) \
        + b.float().abs()


def _check(args, di, gn, card):
    before = kernel.LAUNCHES["fused"]
    z, out, dt = ops.ssm_conv(*args, d_inner=di, gn=gn)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["fused"] == before + 1
    bsz, t, _ = args[0].shape
    assert out.shape == (bsz, t, di + 2 * gn) and out.dtype == torch.float32
    assert dt.shape == (bsz, t, args[3].shape[0]) and out.is_contiguous()
    assert z.data_ptr() == args[0].data_ptr() and z.shape == (bsz, t, di)
    _, want, want_dt = _float32_chain(*args, di, gn)
    torch.testing.assert_close(out, want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(dt, want_dt, rtol=TOL, atol=TOL)
    if args[0].dtype == torch.bfloat16:
        _, eager, eager_dt = ref.conv_chain(*args, di, gn)
        bound = 12 * U_BF16 * _scale(args[0], args[1], args[2], di, gn) \
            + 1e-6
        err = (out - eager).abs()
        assert bool((err <= bound).all()), float((err - bound).max())
        torch.testing.assert_close(dt, eager_dt, rtol=TOL, atol=TOL)
    return out, dt


# mamba2-2.7b's (d_inner 5120, G N 128) and zamba2-2.7b's (G N 64) widths,
# H 80, at two call shapes of the benchmark's mix
@pytest.mark.gpu
@pytest.mark.parametrize("gn", [128, 64], ids=["mamba2", "zamba2"])
@pytest.mark.parametrize("bsz,t", [(9, 896), (2, 4096)])
def test_kernel_at_the_models_widths(card, bsz, t, gn):
    _check(_inputs(bsz, t, 5120, gn, 80, card), 5120, gn, card)


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,t,di,gn,h,dtype", [
    (3, 100, 256, 32, 8, torch.bfloat16),     # T not a multiple of 32
    (2, 1, 128, 16, 8, torch.bfloat16),       # T < K
    (2, 3, 128, 16, 8, torch.bfloat16),
    (1, 70, 102, 3, 4, torch.bfloat16),       # C = 108, not a multiple of 8
    (2, 45, 37, 5, 3, torch.bfloat16),        # C = 47: scalar, a part group
    (2, 77, 5120, 128, 80, torch.float32),    # the float32 model's
    (1, 33, 64, 8, 2, torch.float32),         # H = 2: rows of 584 B, scalar
])
def test_kernel_on_ragged_shapes(card, bsz, t, di, gn, h, dtype):
    _check(_inputs(bsz, t, di, gn, h, card, dtype=dtype), di, gn, card)


@pytest.mark.gpu
def test_each_batch_row_starts_from_zero_history(card):
    """Row b of a batch equals the same row run alone, bit for bit."""
    args = _inputs(4, 130, 5120, 128, 80, card)
    out, dt = ops.ssm_conv(*args, d_inner=5120, gn=128)[1:]
    for row in range(4):
        alone = ops.ssm_conv(args[0][row:row + 1].contiguous(), *args[1:],
                             d_inner=5120, gn=128)[1:]
        assert torch.equal(out[row:row + 1], alone[0])
        assert torch.equal(dt[row:row + 1], alone[1])


@pytest.mark.gpu
def test_kernel_reads_strided_and_misaligned_views(card):
    """zxbcdt as a view into a wider buffer (row stride 16 bytes more) and
    one starting an element in (scalar accesses): both equal the
    contiguous input's result."""
    args = _inputs(2, 96, 5120, 128, 80, card)
    want = ops.ssm_conv(*args, d_inner=5120, gn=128)[1:]
    w = args[0].shape[-1]
    wide = torch.zeros(2, 96, w + 8, dtype=args[0].dtype, device=card)
    wide[..., :w] = args[0]
    off = torch.zeros(2 * 96 * w + 1, dtype=args[0].dtype, device=card)
    off = off[1:].view(2, 96, w)
    off.copy_(args[0])
    for view, vec in ((wide[..., :w], True), (off, False)):
        assert kernel.vector_ok(view, d_inner=5120, gn=128) is vec
        got = ops.ssm_conv(view, *args[1:], d_inner=5120, gn=128)[1:]
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(card):
    z, w, b, dtb = _inputs(1, 8, 16, 4, 2, card)
    before = dict(kernel.LAUNCHES)
    with pytest.raises(ValueError, match="one type"):
        ops.ssm_conv(z.half(), w.half(), b.half(), dtb.half(), d_inner=16,
                     gn=4)
    for k in (3, 5):
        with pytest.raises(ValueError, match=f"K={k}"):
            ops.ssm_conv(z, torch.zeros(k, 24, dtype=z.dtype, device=card),
                         b, dtb, d_inner=16, gn=4)
    w.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernel.ssm_conv_fwd(z, w, b, dtb, d_inner=16, gn=4)
    got = ops.ssm_conv(z, w, b, dtb, d_inner=16, gn=4)   # the plain chain
    for a, want in zip(got, ref.conv_chain(z, w, b, dtb, 16, 4)):
        assert torch.equal(a, want)
    assert got[1].requires_grad
    assert kernel.LAUNCHES == before


@pytest.mark.gpu
def test_a_card_dtensor_runs_the_kernel_on_local_shards(card):
    """On a (1, 1) mesh (NCCL, a world of one): zxbcdt sharded on batch,
    and on batch and its last dim (replicated first), launches the kernel
    once on the local tensor; the DTensors' local values equal the plain
    tensor's result bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_mesh
    args = _inputs(2, 96, 5120, 128, 80, card)
    want = ops.ssm_conv(*args, d_inner=5120, gn=128)
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    try:
        for placements in ([Shard(0), Replicate()], [Shard(0), Shard(2)]):
            dz = DTensor.from_local(args[0], mesh, placements)
            before = kernel.LAUNCHES["fused"]
            got = ops.ssm_conv(dz, *args[1:], d_inner=5120, gn=128)
            torch.cuda.synchronize()
            assert kernel.LAUNCHES["fused"] == before + 1
            for a, b in zip(got, want):
                assert isinstance(a, DTensor)
                assert tuple(a.placements) == (Shard(0), Replicate())
                assert torch.equal(a.to_local(), b)
    finally:
        dist.destroy_process_group()


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


def _on_the_eager_chain(fn):
    real = ops.ssm_conv
    ops.ssm_conv = lambda zx, w, b, dtb, *, d_inner, gn: ref.conv_chain(
        zx, w, b, dtb, d_inner, gn)
    try:
        return fn()
    finally:
        ops.ssm_conv = real


@pytest.mark.gpu
def test_full_mamba2_on_the_kernel_matches_the_eager_chain(card):
    """mamba2-2.7b at full width and depth (64 layers), weights cast to
    float32 (bf16 rounding through 64 random layers is amplified past any
    useful tolerance, as chip_smoke.py's decode gate finds): the prefill
    through the kernel against the same prefill on the eager chain, within
    LOGIT_TOL_F32 of the logits' largest magnitude."""
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
        assert kernel.LAUNCHES["fused"] == before + cfg.n_layers
        want = _on_the_eager_chain(run)
    err = float((got - want).abs().max())
    assert err <= LOGIT_TOL_F32 * float(want.abs().max()), err
    del model
    torch.cuda.empty_cache()
