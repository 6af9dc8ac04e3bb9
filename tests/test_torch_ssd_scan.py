"""The port's SSD scan (`repro_torch.kernels.ssd_scan`) against the JAX
package's on the CPU, at the JAX kernel test's shapes (`SSD_SHAPES` of
tests/test_kernels.py: P 8-64, N 16-128, chunk 16-128, G = 1, 2, 4, 8),
from the same seeded numpy inputs.

Tolerances are the JAX tests' own: 1e-4 for the chunked forms and the
quadratic form (tests/test_models_smoke.py holds chunked against
quadratic to it), 2e-4 for the kernel paths (tests/test_kernels.py): the
same float32 algorithm with sums in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jax_ops
from repro.kernels.ssd_scan import ref as jax_kref
from repro.models import ssm as jax_ssm
from repro_torch.kernels.ssd_scan import kernel, ops, ref

SSD_SHAPES = [
    (2, 128, 4, 8, 2, 16, 32), (1, 256, 2, 64, 1, 128, 128),
    (2, 64, 4, 16, 4, 32, 16), (1, 128, 8, 32, 8, 64, 64),
]
CHUNKED_TOL, KERNEL_TOL = 1e-4, 2e-4


def _inputs(b, t, h, p, g, n, seed=7):
    """(xh, dt, a, bh, ch) as numpy float32, drawn as the JAX kernel test
    draws them (softplus dt, a = -exp(0.5 z), B/C scaled by 0.3)."""
    rng = np.random.default_rng(seed)
    z = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, dt = z(b, t, h, p), np.logaddexp(0, z(b, t, h)).astype(np.float32)
    a = -np.exp(z(h) * 0.5).astype(np.float32)
    return x, dt, a, z(b, t, g, n) * 0.3, z(b, t, g, n) * 0.3


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("n", [1, 7, 16])
def test_segsum(n):
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    got, want = ref.segsum(torch.from_numpy(x)), jax_ssm.segsum(
        jnp.asarray(x))
    np.testing.assert_array_equal(np.isinf(got.numpy()),
                                  np.isinf(np.asarray(want)))
    fin = np.isfinite(np.asarray(want))
    np.testing.assert_allclose(got.numpy()[fin], np.asarray(want)[fin],
                               rtol=CHUNKED_TOL, atol=CHUNKED_TOL)


@pytest.mark.parametrize("b,t,h,p,g,n,q", SSD_SHAPES)
@pytest.mark.parametrize("fn", ["ssd_chunk_scan", "ssd_chunk_scan_streaming",
                                "ssd_reference"])
def test_plain_forms_match_jax(fn, b, t, h, p, g, n, q):
    args = _inputs(b, t, h, p, g, n)
    extra = () if fn == "ssd_reference" else (q,)
    got = getattr(ref, fn)(*map(torch.from_numpy, args), *extra)
    want = getattr(jax_ssm, fn)(*map(jnp.asarray, args), *extra)
    assert tuple(got.shape) == (b, t, h, p)
    _close(got, want, CHUNKED_TOL)


@pytest.mark.parametrize("b,t,h,p,g,n,q", SSD_SHAPES)
@pytest.mark.parametrize("fn", ["ssd_chunk_scan", "ssd_chunk_scan_streaming"])
def test_steps_compose_to_jax(fn, b, t, h, p, g, n, q):
    """The four step functions (the tensor-core route's plain versions),
    composed by hand, equal the JAX package's chunked forms."""
    xh, dt, a, bh, ch = map(torch.from_numpy, _inputs(b, t, h, p, g, n))
    cb = ref.chunk_cb(ch, bh, q)
    states = ref.chunk_states(xh, dt, a, bh, q)
    assert tuple(cb.shape) == (b, t // q, g, q, q)
    assert tuple(states.shape) == (b, t // q, h, n, p)
    prev = ref.state_passing(states, dt, a, q)
    assert not prev[:, 0].any()                   # no state enters chunk 0
    got = ref.chunk_outputs(xh, dt, a, ch, cb, prev, q)
    want = getattr(jax_ssm, fn)(*map(jnp.asarray, _inputs(b, t, h, p, g, n)),
                                q)
    _close(got, want, CHUNKED_TOL)


@pytest.mark.parametrize("b,t,h,p,g,n,q", SSD_SHAPES)
def test_chunked_forms_match_quadratic(b, t, h, p, g, n, q):
    xh, dt, a, bh, ch = map(torch.from_numpy, _inputs(b, t, h, p, g, n))
    quad = ref.ssd_reference(xh, dt, a, bh, ch)
    for fn in (ref.ssd_chunk_scan, ref.ssd_chunk_scan_streaming):
        _close(fn(xh, dt, a, bh, ch, q), quad.numpy(), CHUNKED_TOL)


@pytest.mark.parametrize("b,t,h,p,g,n,q", SSD_SHAPES)
def test_flat_oracle_matches_jax(b, t, h, p, g, n, q):
    """`ssd_scan_ref` on the kernel's flattened [B*H, T, .] layout."""
    x, dt, a, bh, ch = _inputs(b, t, h, p, g, n)
    rep = h // g
    flat = lambda v: np.ascontiguousarray(
        v.transpose(0, 2, 1, 3).reshape(b * h, t, -1))
    be, ce = np.repeat(bh, rep, axis=2), np.repeat(ch, rep, axis=2)
    args = (flat(x), flat(dt[..., None]), flat((dt * a)[..., None]),
            flat(be), flat(ce))
    got = ref.ssd_scan_ref(*map(torch.from_numpy, args))
    _close(got, jax_kref.ssd_scan_ref(*map(jnp.asarray, args)), KERNEL_TOL)


@pytest.mark.parametrize("b,t,h,p,g,n,q", SSD_SHAPES)
def test_op_matches_jax_kernel(b, t, h, p, g, n, q):
    """The port's op on CPU tensors against the Pallas kernel in interpret
    mode, as tests/test_kernels.py runs it."""
    args = _inputs(b, t, h, p, g, n)
    before = kernel.LAUNCHES["ssd"]
    got = ops.ssd_scan(*map(torch.from_numpy, args), chunk=q)
    want = jax_ops.ssd_scan(*map(jnp.asarray, args), chunk=q,
                            interpret=True)
    assert kernel.LAUNCHES["ssd"] == before     # no kernel on the CPU
    _close(got, want, KERNEL_TOL)


def test_op_reads_strided_views():
    """xh, B and C as slices of one conv-output-shaped tensor, as the model
    passes them: same result as contiguous copies."""
    b, t, h, p, g, n, q = 2, 64, 4, 16, 2, 32, 16
    rng = np.random.default_rng(3)
    conv = torch.from_numpy(rng.standard_normal(
        (b, t, h * p + 2 * g * n)).astype(np.float32))
    xh = conv[..., :h * p].reshape(b, t, h, p)
    bh = conv[..., h * p:h * p + g * n].reshape(b, t, g, n)
    ch = conv[..., h * p + g * n:].reshape(b, t, g, n)
    assert not xh.is_contiguous() and not bh.is_contiguous()
    _, dt, a, _, _ = map(torch.from_numpy, _inputs(b, t, h, p, g, n))
    got = ops.ssd_scan(xh, dt, a, bh, ch, chunk=q)
    want = ops.ssd_scan(xh.contiguous(), dt, a, bh.contiguous(),
                        ch.contiguous(), chunk=q)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _zeros(b, t, h, p, g, n):
    return (torch.zeros(b, t, h, p), torch.zeros(b, t, h), torch.zeros(h),
            torch.zeros(b, t, g, n), torch.zeros(b, t, g, n))


@pytest.mark.parametrize("b,t,h,p,g,n,q,route", [
    (4, 2048, 80, 64, 1, 128, 128, "tc"),      # mamba2-2.7b
    (1, 2048, 80, 64, 1, 64, 128, "tc"),       # zamba2-2.7b
    (2, 512, 80, 64, 2, 128, 128, "tc"),       # G = 2, 40 heads a group
    (2, 512, 80, 64, 80, 128, 128, "tc"),      # G = H
    (1, 128, 4, 64, 1, 128, 128, "tc"),        # T of one chunk
    (1, 128, 8, 32, 8, 64, 64, "tc"),          # SSD_SHAPES[3]
    (1, 256, 2, 64, 1, 128, 128, "tc"),        # SSD_SHAPES[1]
    (1, 64, 2, 32, 1, 32, 64, "tc"),           # the smallest P, N, Q taken
    (2, 128, 4, 8, 2, 16, 32, "simt"),         # SSD_SHAPES[0]
    (2, 64, 4, 16, 4, 32, 16, "simt"),         # SSD_SHAPES[2]
    (1, 256, 2, 16, 1, 128, 128, "simt"),      # P below a wgmma tile's 32
    (1, 256, 2, 64, 1, 16, 128, "simt"),       # N below one 32-wide panel
    (1, 256, 2, 64, 1, 128, 32, "simt"),       # chunk below 64
], ids=lambda v: str(v))
def test_choose_route(b, t, h, p, g, n, q, route):
    args = _zeros(b, t, h, p, g, n)
    kernel.check_inputs(*args, chunk=q)
    assert kernel.choose_route(*args, chunk=q) == route


@pytest.mark.parametrize("case", ["x_row", "b_row", "c_offset", "x_offset"])
def test_choose_route_needs_16_byte_alignment(case):
    """cp.async reads x, B and C 16 bytes at a time: a row stride or a base
    address off 16 bytes keeps the inputs on the SIMT kernel."""
    b, t, h, p, g, n, q = 1, 128, 2, 64, 1, 128, 128
    xh, dt, a, bh, ch = _zeros(b, t, h, p, g, n)
    if case == "x_row":      # rows of H*P + 1 floats
        xh = torch.zeros(b, t, h * p + 1)[..., :h * p].reshape(b, t, h, p)
    elif case == "b_row":
        bh = torch.zeros(b, t, g * n + 2)[..., :g * n].reshape(b, t, g, n)
    elif case == "c_offset":
        ch = torch.zeros(b, t, g * n + 1)[..., 1:].reshape(b, t, g, n)
    elif case == "x_offset":
        xh = torch.zeros(b * t * h * p + 3)[3:].reshape(b, t, h, p)
    kernel.check_inputs(xh, dt, a, bh, ch, chunk=q)
    assert kernel.choose_route(xh, dt, a, bh, ch, chunk=q) == "simt"
    fresh = lambda v: v.clone(memory_format=torch.contiguous_format)
    assert kernel.choose_route(fresh(xh), dt, a, fresh(bh), fresh(ch),
                               chunk=q) == "tc"


def _good():
    return [torch.from_numpy(v) for v in _inputs(1, 32, 4, 8, 2, 16)]


@pytest.mark.parametrize("case,match", [
    ("ragged", "not a multiple of the chunk"),
    ("devices", "one device"),
    ("dtype", "float32"),
    ("groups", "not a multiple of 3 groups"),
    ("head_dim", "head dim"),
    ("state_dim", "state dim"),
    ("chunk", "chunk 24"),
    ("shape", "shapes disagree"),
    ("stride", "unit stride"),
])
def test_check_inputs_raises(case, match):
    xh, dt, a, bh, ch = _good()
    chunk = 16
    if case == "ragged":
        xh, dt, bh, ch = xh[:, :24], dt[:, :24], bh[:, :24], ch[:, :24]
    elif case == "devices":
        a = a.to("meta")
    elif case == "dtype":
        xh = xh.double()
    elif case == "groups":
        bh = ch = torch.zeros(1, 32, 3, 16)
    elif case == "head_dim":
        xh = torch.zeros(1, 32, 4, 12)
    elif case == "state_dim":
        bh = ch = torch.zeros(1, 32, 2, 24)
    elif case == "chunk":
        chunk = 24
    elif case == "shape":
        dt = dt[:, :, :2]
    elif case == "stride":
        xh = torch.zeros(1, 32, 4, 16)[..., ::2]
    with pytest.raises(ValueError, match=match):
        kernel.check_inputs(xh, dt, a, bh, ch, chunk=chunk)
    with pytest.raises(ValueError, match=match):
        ops.ssd_scan(xh, dt, a, bh, ch, chunk=chunk)


def test_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="no SSD-scan kernel"):
        kernel.ssd_scan_fwd(*_good(), chunk=16)
    with pytest.raises(ValueError, match="no SSD-scan kernel"):
        kernel.ssd_tc_steps(*_zeros(1, 128, 2, 64, 1, 128), chunk=128)
