"""The port's CUDA kernel for the RMS norm (`kernels/rms_norm`) against its
plain PyTorch version (`ref.rms_norm`, the eager float32 chain), and
models through it, on the card.

Needs an NVIDIA GPU of compute capability 9.0 and nvcc, so every test here
is marked `gpu` and skips on a host without one.  The file imports nothing
of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_rms_norm_gpu.py

Tolerances.  The kernel rounds where the eager chain rounds; only the order
of the float32 sum of squares differs from ATen's reduction, which moves a
row's scale by a float32 ulp or so.  In bf16 that can flip the output's
one rounding: at least 99% of the values are equal, every one within one
bf16 ulp of the eager output.  In float32 the scale's ulp reaches every
value of the row: within 1e-6 relative.  A whole model on the kernel
against the same model on the eager chain: `chip_smoke.py`'s LOGIT_TOL."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.rms_norm import kernel, ops, ref
from repro_torch.models import decode_step, forward, init_cache, init_model

EPS = 1e-5
TOL_F32 = 1e-6
LOGIT_TOL = 5e-2           # chip_smoke.py's: max |a - b| <= tol * max |b|
BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture
def card():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA GPU of compute capability 9.0")
    return torch.device("cuda", 0)


def _inputs(shape, dev, dtype=BF16, wdtype=None, seed=0):
    """x of `shape` (residual-stream scale, a few outliers) and a weight
    [d] of 1 + normal(0, 0.1), as the benchmark's norm scales."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[::97] *= 30.0
    w = 1 + 0.1 * rng.standard_normal(shape[-1]).astype(np.float32)
    return (torch.from_numpy(x).to(dev, dtype),
            torch.from_numpy(w).to(dev, wdtype or dtype))


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def _check(x, w):
    """One launch, and the eager chain's values as the module says."""
    before = kernel.LAUNCHES["fused"]
    with torch.no_grad():
        got = ops.rms_norm(x, w, EPS)
        want = ref.rms_norm(x, w, EPS)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["fused"] == before + 1
    assert got.shape == x.shape and got.dtype == x.dtype
    assert got.is_contiguous()
    g, r = got.float(), want.float()
    if x.dtype == BF16:
        assert float((g == r).float().mean()) >= 0.99
        ulp = _bf16_ulp(torch.maximum(g.abs(), r.abs()))
        err = (g - r).abs()
        assert bool((err <= ulp).all()), float((err / ulp).max())
    else:
        torch.testing.assert_close(g, r, rtol=TOL_F32, atol=TOL_F32)
    return got


def _cells_shapes():
    """[B, S, d_model] of every call of the benchmark's three cells
    (phi3-mini-3.8b.conv-2k, mamba2-2.7b.code-4k and
    granite-4.0-h-small.code-4k), as its files give them."""
    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from portbench.harness import load_cell, schedule
    out = []
    for name in ("phi3-mini-3.8b.conv-2k", "mamba2-2.7b.code-4k",
                 "granite-4.0-h-small.code-4k"):
        cell = load_cell(root, name)
        out += [(b, s, cell.model["d_model"])
                for b, s in sorted(set(schedule(cell.traffic)))]
    return out


CELLS = _cells_shapes()


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d", CELLS)
def test_kernel_at_the_cells_shapes(card, b, s, d):
    x, w = _inputs((b, s, d), card)
    assert kernel.vector_ok(x, w)
    _check(x, w)


# every d the registry's norms take (576-6144, MLA's latents 256, 512 and
# 768, the benchmark's 4096), the Mamba2 decode step's gate norm over
# d_inner (5120 in mamba2-2.7b and zamba2-2.7b, 8192 in
# granite-4.0-h-small), the reduced configs' 64 and 32, and the widest the
# kernel takes (16,384: 512 threads a row)
WIDTHS = [576, 1024, 1536, 2048, 2560, 3072, 4096, 6144, 256, 512, 768,
          5120, 8192, 64, 32, 16384]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("d", WIDTHS)
def test_kernel_at_every_width(card, d, dtype):
    x, w = _inputs((3, 37, d), card, dtype)
    assert kernel.vector_ok(x, w)
    _check(x, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("rank,rope", [(512, 64), (256, 32)],
                         ids=["deepseek-v2-lite", "minicpm3"])
def test_kernel_on_mla_strided_latent(card, rank, rope, dtype):
    """MLA's `c_kv`: a `torch.split` view of [B, S, rank + rope], rows
    rank + rope apart, read in place (no copy) in 16-byte accesses."""
    buf, w = _inputs((2, 96, rank + rope), card, dtype)
    c_kv, _ = torch.split(buf, [rank, rope], dim=-1)
    w = w[:rank].contiguous()
    assert not c_kv.is_contiguous() and kernel.vector_ok(c_kv, w)
    got = _check(c_kv, w)
    assert torch.equal(got, ops.rms_norm(c_kv.contiguous(), w, EPS))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("shape", [(1, 1, 3072), (3072,), (1, 2560),
                                   (2, 1, 5, 4096)],
                         ids=["one row", "1-D", "2-D", "4-D"])
def test_kernel_at_one_row_and_other_ranks(card, shape, dtype):
    _check(*_inputs(shape, card, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_no_rows_launch_nothing(card, dtype):
    x, w = _inputs((2, 0, 3072), card, dtype)
    before = kernel.LAUNCHES["fused"]
    with torch.no_grad():
        got = ops.rms_norm(x, w, EPS)
    assert got.shape == (2, 0, 3072) and got.dtype == dtype
    assert kernel.LAUNCHES["fused"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["offset", "row stride", "weight offset"])
def test_a_copied_input_equals_the_one_read_in_place(card, case):
    """x starting one element in, rows of an odd stride, or a weight
    starting one element in: the kernel reads a contiguous copy, in one
    launch, with the values of the aligned input."""
    x, w = _inputs((4, 33, 2560), card)
    with torch.no_grad():
        want = ops.rms_norm(x, w, EPS)
    if case == "offset":
        buf = torch.empty(x.numel() + 1, dtype=BF16, device=card)
        buf[1:] = x.flatten()
        x = buf[1:].view(x.shape)
    elif case == "row stride":
        wide = torch.zeros(4, 33, 2561, dtype=BF16, device=card)
        wide[..., :2560] = x
        x = wide[..., :2560]
    else:
        w = torch.cat([w[:1], w])[1:]
    assert not kernel.vector_ok(x, w)
    assert torch.equal(_check(x, w), want)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(card):
    x, w = _inputs((2, 8, 256), card)
    before = dict(kernel.LAUNCHES)
    with pytest.raises(ValueError, match="types"):
        ops.rms_norm(x.half(), w.half(), EPS)
    for xx, ww in ((x, w.float()), (x.float(), w)):
        with pytest.raises(ValueError, match="types"):
            ops.rms_norm(xx, ww, EPS)
    for d, dtype in ((100, BF16), (33, F32), (8202, BF16)):
        with pytest.raises(ValueError, match="multiple of"):
            ops.rms_norm(*_inputs((2, 8, d), card, dtype), EPS)
    with pytest.raises(ValueError, match="length"):
        ops.rms_norm(x, w[:128], EPS)
    w.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernel.rms_norm_fwd(x, w, eps=EPS)
    got = ops.rms_norm(x, w, EPS)
    assert got.requires_grad and torch.equal(got, ref.rms_norm(x, w, EPS))
    assert kernel.LAUNCHES == before


@pytest.mark.gpu
def test_a_card_dtensor_runs_the_kernel_on_local_shards(card):
    """On a (1, 1) mesh (NCCL, a world of one): x sharded on batch, on
    batch and sequence, and on batch and the normed dim (replicated
    first) launches the kernel once on the local tensor; the local value
    equals the plain tensor's result bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_mesh
    x, w = _inputs((2, 128, 2560), card)
    with torch.no_grad():
        want = ops.rms_norm(x, w, EPS)
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    try:
        for pl, out in (([Shard(0), Replicate()], [Shard(0), Replicate()]),
                        ([Shard(0), Shard(1)], [Shard(0), Shard(1)]),
                        ([Shard(0), Shard(2)], [Shard(0), Replicate()])):
            dx = DTensor.from_local(x, mesh, pl)
            before = kernel.LAUNCHES["fused"]
            with torch.no_grad():
                got = ops.rms_norm(dx, w, EPS)
            torch.cuda.synchronize()
            assert kernel.LAUNCHES["fused"] == before + 1
            assert isinstance(got, DTensor) and list(got.placements) == out
            assert torch.equal(got.to_local(), want)
    finally:
        dist.destroy_process_group()


def _on_the_eager_chain(fn):
    real = ops.rms_norm
    ops.rms_norm = ref.rms_norm
    try:
        return fn()
    finally:
        ops.rms_norm = real


@pytest.mark.gpu
@pytest.mark.parametrize("arch,layers,norms", [
    ("phi3-mini-3.8b", 4, 2 * 4 + 1), ("mamba2-2.7b", 4, 4 + 1)])
def test_model_prefill_on_the_kernel(card, arch, layers, norms):
    """The model at full width and reduced depth, bf16: a prefill launches
    the kernel once a norm (2 a block and the final norm in phi3, 1 a
    block and the final in mamba2), and its logits lie within LOGIT_TOL
    of the same prefill on the eager chain."""
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = init_model(cfg, torch.Generator(card).manual_seed(0),
                       device=card)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 256))).to(card)
    run = lambda: forward(model, cfg, {"tokens": tokens},  # noqa: E731
                          logits_mode="last").float()
    with torch.no_grad():
        before = kernel.LAUNCHES["fused"]
        got = run()
        torch.cuda.synchronize()
        assert kernel.LAUNCHES["fused"] == before + norms
        want = _on_the_eager_chain(run)
    err = float((got - want).abs().max())
    assert err <= LOGIT_TOL * float(want.abs().max()), err
    del model
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_mamba2_decode_step_on_the_kernel(card):
    """mamba2-2.7b at full width and 2 layers, bf16: a decode step
    launches the kernel once a residual norm, once a Mamba2 gate norm over
    d_inner (5,120, `models/ssm.py::mamba2_decode`) and once for the
    final norm; 8 steps' logits lie within LOGIT_TOL of the same steps on
    the eager chain."""
    cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=2)
    model = init_model(cfg, torch.Generator(card).manual_seed(0),
                       device=card)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 8))).to(card)

    def run():
        cache = init_cache(cfg, 2, 8, device=card)
        out = []
        for pos in range(8):
            logits, cache = decode_step(model, cfg, cache, tokens[:, pos],
                                        pos)
            out.append(logits.float())
        return torch.stack(out)

    before = kernel.LAUNCHES["fused"]
    got = run()
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["fused"] == before + 8 * (2 * cfg.n_layers + 1)
    want = _on_the_eager_chain(run)
    err = float((got - want).abs().max())
    assert err <= LOGIT_TOL * float(want.abs().max()), err
    del model
    torch.cuda.empty_cache()
