"""The port's CUDA SSD-scan kernels against their plain PyTorch versions
(`ref.ssd_chunk_scan_streaming`, the model's form, and the step functions
of `ref.ssd_chunk_scan`), and the Mamba2 model through them, on the card:
the tensor-core route "tc" (five sub-kernels, each step held to its plain
version through `kernel.ssd_tc_steps`) and the SIMT route, as
`kernel.choose_route` picks or as a test names.

Needs an NVIDIA GPU of compute capability 9.0 and nvcc, so every test here
is marked `gpu` and skips on a host without one.  The file imports nothing
of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssd_gpu.py

Tolerance 2e-4 (absolute and relative) for the kernels and each step, the
JAX kernel test's (tests/test_kernels.py): the same float32 algorithm with
sums in another order (route "tc": products as three TF32 passes, ~float32
accurate); the plain version's products run in full float32 (TF32 off).  1e-4 for the float32 reduced model on the card against the CPU and
for decode against prefill: cuBLAS and the CPU sum the projections in
another order, through 2-4 layers and the LM head."""
import dataclasses
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
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


# the tensor-core route's shapes: the models' (shortened), T of one chunk,
# an odd number of chunks with G = 2 (40 heads a group), SSD_SHAPES[3]
# (Q = 64, P = 32) and [1], and its narrowest (P = N = 32 at Q = 128)
TC_SHAPES = [(2, 512, 80, 64, 1, 128, 128), (1, 1024, 80, 64, 1, 64, 128),
             (2, 128, 8, 64, 1, 128, 128), (1, 384, 80, 64, 2, 128, 128),
             (1, 128, 8, 32, 8, 64, 64), (1, 256, 2, 64, 1, 128, 128),
             (1, 384, 4, 32, 2, 32, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h,p,g,n,q", TC_SHAPES)
def test_tc_steps_match_plain(card, b, t, h, p, g, n, q):
    """Each sub-kernel of route "tc" against its step function: C B^T
    (step 1) on the entries it computes (row tile m of 64 against the
    columns j < 64 (m + 1)), the chunk states (2), the states after passing
    (3), y (4)."""
    xh, dt, a, bh, ch = args = _inputs(b, t, h, p, g, n, card)
    assert kernel.choose_route(*args, chunk=q) == "tc"
    before = dict(kernel.LAUNCHES)
    got = {k: kernel.ssd_tc_steps(*args, chunk=q, last_step=k)
           for k in (1, 2, 3, 4)}
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == {**before,
                               "ssd_steps": before["ssd_steps"] + 4}
    cb = ref.chunk_cb(ch, bh, q)
    states = ref.chunk_states(xh, dt, a, bh, q)
    prev = ref.state_passing(states, dt, a, q)
    i = torch.arange(q, device=card)
    causal = i[None, :] < 64 * (i[:, None] // 64 + 1)
    torch.testing.assert_close(got[1]["cb"][..., causal], cb[..., causal],
                               rtol=TOL, atol=TOL)
    torch.testing.assert_close(got[2]["states"], states[:, :-1], rtol=TOL,
                               atol=TOL)
    torch.testing.assert_close(got[3]["states"], prev[:, 1:], rtol=TOL,
                               atol=TOL)
    torch.testing.assert_close(
        got[4]["y"], ref.chunk_outputs(xh, dt, a, ch, cb, prev, q),
        rtol=TOL, atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["tc", "simt"])
@pytest.mark.parametrize("b,t,h,p,g,n,q", TC_SHAPES)
def test_both_routes_match_plain(card, route, b, t, h, p, g, n, q):
    args = _inputs(b, t, h, p, g, n, card)
    before = dict(kernel.LAUNCHES)
    out = kernel.ssd_scan_fwd(*args, chunk=q, route=route)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["ssd"] == before["ssd"] + 1
    assert kernel.LAUNCHES["ssd_tc"] == before["ssd_tc"] + (route == "tc")
    torch.testing.assert_close(
        out, ref.ssd_chunk_scan_streaming(*args, q), rtol=TOL, atol=TOL)


@pytest.mark.gpu
def test_tc_route_refuses_what_it_does_not_take(card):
    args = _inputs(2, 64, 4, 16, 4, 32, card)
    assert kernel.choose_route(*args, chunk=16) == "simt"
    with pytest.raises(ValueError, match="tensor-core route does not take"):
        kernel.ssd_scan_fwd(*args, chunk=16, route="tc")
    with pytest.raises(ValueError, match="tensor-core route does not take"):
        kernel.ssd_tc_steps(*args, chunk=16)
    with pytest.raises(ValueError, match="route 'wgmma' not in"):
        kernel.ssd_scan_fwd(*args, chunk=16, route="wgmma")


@pytest.mark.gpu
def test_tc_kernels_run_on_the_tensor_cores(card):
    """In SASS, every instantiation of route "tc"'s three product kernels
    (C B^T, chunk states, outputs) issues HGMMA (wgmma)."""
    from torch.utils.cpp_extension import CUDA_HOME
    cuobjdump = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    if not cuobjdump.exists():
        pytest.skip("the toolkit has no cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(kernel.LIBRARY.build())], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    hgmma = {name: bool(re.search(r"\bHGMMA\b", body))
             for name, body in re.findall(
                 r"Function : (\S+)(.*?)(?=Function : |\Z)", sass, re.S)}
    for kname in ("ssd_cb_kernel", "ssd_states_kernel", "ssd_out_kernel"):
        found = [v for k, v in hgmma.items() if kname in k]
        assert found and all(found), (kname, found)


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
    before = dict(kernel.LAUNCHES)
    with pytest.raises(RuntimeError, match="no backward"):
        kernel.ssd_scan_fwd(*args, chunk=16)
    got = ops.ssd_scan(*args, chunk=16)     # the plain scan
    assert got.requires_grad and torch.equal(
        got, ref.ssd_chunk_scan_streaming(*args, 16))
    assert kernel.LAUNCHES == before


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


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_model_prefill_on_the_tensor_cores(card, arch):
    """The reduced model with the full model's SSM widths (heads of 64,
    its d_state) and chunk 64: forward on the card calls the op once a
    Mamba2 layer, every call on route "tc", and equals the same float32
    model on the CPU."""
    cfg = dataclasses.replace(reduced_config(arch), ssm_headdim=64,
                              d_state=get_config(arch).d_state, chunk=64)
    host = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    model = init_model(cfg, torch.Generator().manual_seed(0), device=card)
    model.load_state_dict(host.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 192)))
    with torch.no_grad():
        want = forward(host, cfg, {"tokens": tokens})
        before = dict(kernel.LAUNCHES)
        got = forward(model, cfg, {"tokens": tokens.to(card)})
        torch.cuda.synchronize()
    assert kernel.LAUNCHES["ssd"] == before["ssd"] + cfg.n_layers
    assert kernel.LAUNCHES["ssd_tc"] == before["ssd_tc"] + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
