"""The port's CUDA SSD-scan kernel against its plain PyTorch version
(`ref.ssd_chunk_scan_streaming`, the model's form), and the Mamba2 model
through it, on the card.

Needs an NVIDIA GPU of compute capability 9.0 and nvcc, so every test here
is marked `gpu` and skips on a host without one.  The file imports nothing
of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssd_gpu.py

Tolerance 2e-4 (absolute and relative) for the kernel, the JAX kernel
test's (tests/test_kernels.py): the same float32 algorithm with sums in
another order; the plain version's products run in full float32 (TF32
off).  1e-4 for the float32 reduced model on the card against the CPU and
for decode against prefill: cuBLAS and the CPU sum the projections in
another order, through 2-4 layers and the LM head."""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels.ssd_scan import kernel, ops, ref
from repro_torch.models import decode_step, forward, init_cache, init_model

TOL = 2e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA GPU of compute capability 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version's
    return torch.device("cuda", 0)                  # products in full fp32


def _inputs(b, t, h, p, g, n, dev, seed=0):
    """As the JAX kernel test draws them: softplus dt, a = -exp(0.5 z),
    B/C scaled by 0.3."""
    rng = np.random.default_rng(seed)
    z = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev)
    return (z(b, t, h, p), torch.nn.functional.softplus(z(b, t, h)),
            -torch.exp(z(h) * 0.5), z(b, t, g, n) * 0.3, z(b, t, g, n) * 0.3)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h,p,g,n,q", [
    (2, 128, 4, 8, 2, 16, 32), (1, 256, 2, 64, 1, 128, 128),
    (2, 64, 4, 16, 4, 32, 16), (1, 128, 8, 32, 8, 64, 64),
    (1, 2048, 80, 64, 1, 64, 128), (4, 512, 80, 64, 1, 128, 128),
    (3, 48, 6, 16, 3, 16, 16),
])
def test_kernel_matches_ref(card, b, t, h, p, g, n, q):
    args = _inputs(b, t, h, p, g, n, card)
    before = kernel.LAUNCHES["ssd"]
    out = ops.ssd_scan(*args, chunk=q)
    want = ref.ssd_chunk_scan_streaming(*args, q)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["ssd"] == before + 1
    assert out.shape == (b, t, h, p) and out.dtype == torch.float32
    torch.testing.assert_close(out, want, rtol=TOL, atol=TOL)


@pytest.mark.gpu
def test_kernel_reads_strided_views(card):
    """xh, B and C as slices of one conv-output-shaped tensor, as the model
    passes them: no copy, same result as contiguous inputs."""
    b, t, h, p, g, n, q = 2, 256, 8, 64, 2, 128, 128
    conv = torch.randn(b, t, h * p + 2 * g * n, device=card,
                       generator=torch.Generator(card).manual_seed(0))
    xh = conv[..., :h * p].reshape(b, t, h, p)
    bh = conv[..., h * p:h * p + g * n].reshape(b, t, g, n) * 0.3
    ch = conv[..., h * p + g * n:].reshape(b, t, g, n)
    assert not xh.is_contiguous() and not ch.is_contiguous()
    _, dt, a, _, _ = _inputs(b, t, h, p, g, n, card)
    out = ops.ssd_scan(xh, dt, a, bh, ch, chunk=q)
    torch.testing.assert_close(
        out, ref.ssd_chunk_scan_streaming(xh, dt, a, bh, ch, q),
        rtol=TOL, atol=TOL)
    torch.testing.assert_close(
        out, ops.ssd_scan(xh.contiguous(), dt, a, bh, ch.contiguous(),
                          chunk=q), rtol=0, atol=0)


@pytest.mark.gpu
def test_kernel_matches_float64_on_unit_scale_views(card):
    """Unit-scale B and C with the model's A (-1 .. -16), y up to ~300:
    the kernel, whose cumulative sum of dA runs in double precision, stays
    within the tolerance of the plain version evaluated in float64; the
    float32 plain version itself does not (PERF.md)."""
    b, t, h, p, g, n, q = 2, 1024, 80, 64, 1, 128, 128
    rng = np.random.default_rng(0)
    z = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(card)
    conv = z(b, t, h * p + 2 * g * n)
    dt = torch.nn.functional.softplus(z(b, t, h))
    a = -torch.linspace(1.0, 16.0, h, device=card)
    args = (conv[..., :h * p].reshape(b, t, h, p), dt, a,
            conv[..., h * p:h * p + g * n].reshape(b, t, g, n),
            conv[..., h * p + g * n:].reshape(b, t, g, n))
    out = ops.ssd_scan(*args, chunk=q)
    truth = ref.ssd_chunk_scan_streaming(*[v.double() for v in args], q)
    torch.testing.assert_close(out.double(), truth, rtol=TOL, atol=TOL)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(card):
    args = list(_inputs(1, 64, 2, 16, 1, 16, card))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(*args, chunk=128)
    args[0] = args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_scan(*args, chunk=16)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_model_prefill_through_the_kernel(card, arch):
    """forward on the card launches the kernel once a Mamba2 layer and
    equals the same float32 model on the CPU; decode on the card equals
    its own prefill."""
    cfg = reduced_config(arch)
    host = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    model = init_model(cfg, torch.Generator().manual_seed(0), device=card)
    model.load_state_dict(host.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (3, 64)))
    with torch.no_grad():
        want = forward(host, cfg, {"tokens": tokens})
        before = kernel.LAUNCHES["ssd"]
        got = forward(model, cfg, {"tokens": tokens.to(card)})
        torch.cuda.synchronize()
    assert kernel.LAUNCHES["ssd"] == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    cache = init_cache(cfg, 3, 64, device=card)
    for pos in range(tokens.shape[1]):
        logits, cache = decode_step(model, cfg, cache,
                                    tokens[:, pos].to(card), pos)
    torch.testing.assert_close(logits, got[:, -1], rtol=1e-4, atol=1e-4)
