"""Mamba2's gate chain op (`repro_torch.kernels.ssm_gate`) on the CPU: its
plain version equals the eager lines `mamba2_forward` ran before the op
bit for bit; the op sends CPU and meta inputs to it, and runs on a
DTensor's local tensors, and sends a forward recorded by autograd to the
plain chain, never to the kernel; the op runs inside the "ssm.gate" span; the
wrapper's checks, its 16-byte-access rule and its copies of what breaks
that rule run here.  The kernel itself runs on the card
(tests/test_torch_ssm_gate_gpu.py); the layer against the JAX package is
tests/test_torch_ssm.py.  No JAX here."""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import reduced_config
from repro_torch.kernels.ssm_gate import kernel, ops, ref
from repro_torch.launch import dryrun
from repro_torch.models import init_model, ssm
from repro_torch.models.layers import rms_norm
from repro_torch.obs import Tracer, activate


def _eager_lines(y, xh, D, z, out_norm, eps, dtype):
    """The chain as `mamba2_forward` wrote it before the op, inline."""
    b, t, h, p = y.shape
    y = y + xh * D.float()[None, None, :, None]
    y = y.reshape(b, t, h * p).to(dtype)
    return rms_norm(y * F.silu(z), out_norm, eps)


def _layout(bsz, t, h, p, gn, dtype=torch.bfloat16, device="cpu",
            seed=0):
    """The model's layout: y [B, T, H, P] float32 contiguous (the scan's
    output), xh the first H P columns of a float32 [B, T, H P + 2 gn]
    (the conv's output) split into heads, z the first H P columns of
    in_proj's [B, T, 2 H P + 2 gn + H], D [H], out_norm [H P]."""
    g = torch.Generator().manual_seed(seed)
    di = h * p

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g) * scale).to(device)

    conv32 = r(bsz, t, di + 2 * gn)
    zxbcdt = r(bsz, t, 2 * di + 2 * gn + h, scale=2.0).to(dtype)
    return (r(bsz, t, h, p), conv32[..., :di].unflatten(-1, (h, p)),
            (1 + 0.5 * r(h)).to(dtype), zxbcdt[..., :di],
            (1 + 0.1 * r(di)).to(dtype))


# reduced mamba2 (H 8 of P 16), the reduced models at heads of 64 (H 2),
# an odd head size, mamba2-2.7b's width (H 80 of 64), B > 1 and T = 1
SHAPES = [(2, 16, 8, 16, 16), (2, 16, 2, 64, 16), (3, 5, 3, 7, 2),
          (1, 3, 80, 64, 128), (4, 1, 8, 16, 16)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bsz,t,h,p,gn", SHAPES)
def test_plain_version_is_the_eager_lines_bit_for_bit(bsz, t, h, p, gn,
                                                      dtype):
    args = _layout(bsz, t, h, p, gn, dtype)
    want = _eager_lines(*args, 1e-5, dtype)
    for got in (ref.gate_chain(*args, 1e-5, dtype),
                ops.ssm_gate(*args, eps=1e-5, dtype=dtype)):
        assert got.dtype == want.dtype == dtype
        assert got.shape == (bsz, t, h * p)
        assert torch.equal(got, want)


@pytest.fixture
def no_kernel(monkeypatch):
    """Replace the kernel's wrapper by one that records calls and fails."""
    calls = []

    def refuse(*a, **k):
        calls.append(a)
        raise AssertionError("the kernel was called")

    monkeypatch.setattr(kernel, "ssm_gate_fwd", refuse)
    return calls


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_op_sends_cpu_and_meta_tensors_to_the_plain_chain(no_kernel,
                                                          monkeypatch,
                                                          device):
    seen = []
    real = ops.gate_chain

    def spy(*a):
        seen.append(a[0].device.type)
        return real(*a)

    monkeypatch.setattr(ops, "gate_chain", spy)
    args = _layout(2, 4, 8, 16, 16, device=device)
    out = ops.ssm_gate(*args, eps=1e-5, dtype=torch.bfloat16)
    assert seen == [device] and not no_kernel
    assert out.device.type == device and out.shape == (2, 4, 128)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("shard", ["batch", "batch and heads"])
def test_a_dtensor_runs_the_op_on_local_shards(no_kernel, monkeypatch,
                                               shard):
    """On a one-rank mesh, under `implicit_replication` as the sharded
    steps run: the op runs on each rank's local tensors (here the plain
    version, for CPU tensors; never on a DTensor), keeps a batch shard of
    y, replicates a shard of its heads (the RMS norm reduces over them),
    and returns a DTensor equal to the chain on the local tensors."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import make_mesh
    seen = []
    real = ops.gate_chain

    def spy(*a):
        seen.append(type(a[0]))
        return real(*a)

    monkeypatch.setattr(ops, "gate_chain", spy)
    args = _layout(2, 8, 8, 16, 16)
    heads = {"batch": [Shard(0), Replicate()],
             "batch and heads": [Shard(0), Shard(2)]}[shard]
    with dryrun.fake_world(1), implicit_replication():
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        dargs = [DTensor.from_local(v, mesh, heads) for v in args[:2]] + [
            DTensor.from_local(args[2], mesh, [Replicate(), Shard(0)]),
            DTensor.from_local(args[3], mesh, [Shard(0), Replicate()]),
            args[4]]
        got = ops.ssm_gate(*dargs, eps=1e-5, dtype=torch.bfloat16)
        assert isinstance(got, DTensor)
        assert tuple(got.placements) == (Shard(0), Replicate())
        local = got.to_local()
    assert seen == [torch.Tensor] and not no_kernel
    assert torch.equal(local, ref.gate_chain(*args, 1e-5, torch.bfloat16))


@pytest.fixture(scope="module")
def layer():
    cfg = reduced_config("mamba2-2.7b")
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, model.layers[0].ssm


@pytest.fixture
def op_calls(monkeypatch):
    calls = []
    real = ops.ssm_gate

    def spy(*a, **k):
        calls.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr(ops, "ssm_gate", spy)
    return calls


class _OnCard(torch.Tensor):
    """A CPU tensor whose device reads CUDA: it takes the op's route to the
    kernel wrapper (stubbed below) on a host without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("grad", [False, True])
def test_grad_mode_picks_the_path(layer, op_calls, no_kernel, monkeypatch,
                                  grad):
    """The op decides by grad mode: while gradients are recorded it calls
    `gate_chain` and never the kernel, on a CUDA tensor too, and the
    gradients reach the layer's weights; otherwise a CUDA tensor goes to
    the kernel wrapper, once.  The model calls the op once a layer either
    way, and the values agree."""
    cfg, p = layer
    chain = []
    real = ops.gate_chain

    def spy(*a):
        chain.append(a[0])
        return real(*a)

    monkeypatch.setattr(ops, "gate_chain", spy)
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    with torch.set_grad_enabled(grad):
        y = ssm.mamba2_forward(p, cfg, x)
    assert len(op_calls) == len(chain) == 1 and chain[0] is op_calls[0]
    assert not no_kernel
    assert y.requires_grad == grad
    if grad:
        y.sum().backward()
        assert p.D.grad is not None and p.out_norm.grad is not None
        p.zero_grad(set_to_none=True)
        with torch.no_grad():
            torch.testing.assert_close(ssm.mamba2_forward(p, cfg, x),
                                       y.detach(), rtol=0, atol=0)
    route = []
    monkeypatch.setattr(ops, "gate_chain",
                        lambda *a: route.append("plain") or a[0])
    monkeypatch.setattr(kernel, "ssm_gate_fwd",
                        lambda *a, **k: route.append("kernel") or a[0])
    card = [v.as_subclass(_OnCard).requires_grad_(True)
            for v in _layout(1, 4, 2, 8, 4)]
    with torch.set_grad_enabled(grad):
        ops.ssm_gate(*card, eps=1e-5, dtype=torch.bfloat16)
    assert route == (["plain"] if grad else ["kernel"])


def test_the_op_runs_inside_the_gate_span(layer, monkeypatch):
    """The "ssm.gate" span is still recorded, once a layer, and the op
    runs inside it (innermost), so the span's device time is the
    kernel's."""
    cfg, p = layer
    tr = Tracer()
    inside = []
    real = ops.ssm_gate

    def spy(*a, **k):
        inside.append(tr._stack()[-1].name)
        return real(*a, **k)

    monkeypatch.setattr(ops, "ssm_gate", spy)
    with torch.no_grad(), activate(tr):
        ssm.mamba2_forward(p, cfg, torch.zeros(1, 16, cfg.d_model),
                           tracer=tr)
    names = [s.name for s in tr.buffer.snapshot()]
    assert names.count("ssm.gate") == 1 and inside == ["ssm.gate"]


def test_forward_launches_no_kernel_on_the_cpu(layer):
    cfg, p = layer
    before = dict(kernel.LAUNCHES)
    with torch.no_grad():
        ssm.mamba2_forward(p, cfg, torch.zeros(1, 16, cfg.d_model))
    assert kernel.LAUNCHES == before


# --------------------------------------------------------------------------
# the wrapper's rules (pure Python)
# --------------------------------------------------------------------------
def _refusal(case):
    y, xh, D, z, w = _layout(1, 4, 2, 8, 4)
    bf = torch.bfloat16
    return {
        "fp16": ((y, xh, D.half(), z.half(), w.half()), torch.float16,
                 "one type"),
        "mixed": ((y, xh, D.float(), z, w), bf, "one type"),
        "output type": ((y, xh, D, z, w), torch.float32, "one type"),
        "bf16 y": ((y.to(bf), xh, D, z, w), bf, "float32 y and xh"),
        "3-D y": ((y.flatten(2), xh, D, z, w), bf, "takes y, xh"),
        "D length": ((y, xh, D[:1], z, w), bf, "disagree"),
        "z width": ((y, xh, D, z[..., :-1], w), bf, "disagree"),
        "z strided": ((y, xh, D, torch.zeros(1, 4, 32, dtype=bf)[..., ::2],
                       w), bf, "unit stride"),
        "y heads apart": ((torch.zeros(1, 4, 2, 9)[..., :8], xh, D, z, w),
                          bf, "unit stride"),
        "w strided": ((y, xh, D, z, torch.zeros(32, dtype=bf)[::2]), bf,
                      "contiguous"),
        "head size": ((torch.zeros(1, 4, 2, 12), torch.zeros(1, 4, 2, 12),
                       D, torch.zeros(1, 4, 24, dtype=bf),
                       torch.zeros(24, dtype=bf)), bf, "multiple of 8"),
        "too wide": ((torch.zeros(1, 1, 257, 64), torch.zeros(1, 1, 257, 64),
                      torch.zeros(257, dtype=bf),
                      torch.zeros(1, 1, 257 * 64, dtype=bf),
                      torch.zeros(257 * 64, dtype=bf)), bf, "above"),
        "cpu": ((y, xh, D, z, w), bf, "no ssm_gate kernel for device"),
    }[case]


@pytest.mark.parametrize("case", ["fp16", "mixed", "output type", "bf16 y",
                                  "3-D y", "D length", "z width",
                                  "z strided", "y heads apart", "w strided",
                                  "head size", "too wide", "cpu"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, dtype, match = _refusal(case)
    before = dict(kernel.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        kernel.ssm_gate_fwd(*args, eps=1e-5, dtype=dtype)
    assert kernel.LAUNCHES == before


@pytest.mark.parametrize("bsz,t,h,p,gn,dtype,offset,want", [
    # mamba2-2.7b's and zamba2-2.7b's layers (d_inner 5120, G N 128 and
    # 64), granite-4.0-h-small's (8192, 128), bf16 and float32
    (2, 8, 80, 64, 128, torch.bfloat16, 0, True),
    (2, 8, 80, 64, 64, torch.bfloat16, 0, True),
    (2, 8, 128, 64, 128, torch.bfloat16, 0, True),
    (2, 8, 80, 64, 128, torch.float32, 0, True),
    # the reduced models at heads of 64 (H 2): in_proj's rows of 290
    # columns, 580 bytes of bf16 and 1,160 of float32
    (2, 8, 2, 64, 16, torch.bfloat16, 0, False),
    (2, 8, 2, 64, 16, torch.float32, 0, False),
    # ... which does not matter for a single row
    (1, 1, 2, 64, 16, torch.bfloat16, 0, True),
    # the reduced models' own H 8 of P 16: rows of 296 columns, 592 bytes
    (2, 8, 8, 16, 16, torch.bfloat16, 0, True),
    # in_proj's float32 output starting one element in
    (2, 8, 80, 64, 128, torch.float32, 1, False),
    # in_proj's output starting one element in
    (2, 8, 80, 64, 128, torch.bfloat16, 1, False),
])
def test_vector_rule(bsz, t, h, p, gn, dtype, offset, want):
    y, xh, D, _, w = _layout(bsz, t, h, p, gn, dtype)
    width = 2 * h * p + 2 * gn + h
    buf = torch.zeros(bsz * t * width + offset, dtype=dtype)
    z = buf[offset:].view(bsz, t, width)[..., :h * p]
    assert kernel.vector_ok(y, xh, z, w) is want


@pytest.mark.parametrize("what", ["fits", "offset", "row stride",
                                  "out_norm offset"])
def test_wrapper_copies_only_what_does_not_fit(what):
    """The kernel reads a fitting input in place and a contiguous copy of
    one that breaks the 16-byte rule (equal values, a fresh buffer)."""
    bf = torch.bfloat16
    buf = torch.arange(2 * 8 * 300 + 1, dtype=torch.float32).to(bf)
    v = {"fits": buf[:2 * 8 * 296].view(2, 8, 296)[..., :128],
         "offset": buf[1:2 * 8 * 296 + 1].view(2, 8, 296)[..., :128],
         "row stride": buf[:2 * 8 * 290].view(2, 8, 290)[..., :128],
         "out_norm offset": buf[1:129]}[what]
    got = kernel._fitting(v)
    assert torch.equal(got, v)
    if what == "fits":
        assert got is v
    else:
        assert got.data_ptr() != v.data_ptr() and got.is_contiguous()
        assert kernel._fits(got)
