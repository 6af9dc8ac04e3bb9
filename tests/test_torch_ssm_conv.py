"""Mamba2's conv chain op (`repro_torch.kernels.ssm_conv`) on the CPU: its
plain version equals the eager chain `mamba2_forward` ran before the op
bit for bit; the op sends a forward recorded by autograd to the plain
chain, never to the kernel; decode keeps its own conv; a DTensor runs the
op on its local tensors; the wrapper's checks and its 16-byte-access rule
are pure Python and run here.  The kernel itself
runs on the card (tests/test_torch_ssm_conv_gpu.py); the layer against the
JAX package is tests/test_torch_ssm.py.  No JAX here."""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import reduced_config
from repro_torch.kernels.ssm_conv import kernel, ops, ref
from repro_torch.launch import dryrun
from repro_torch.models import init_model, ssm


def _eager_chain(zxbcdt, w, b, dt_bias, di, gn):
    """The chain as `mamba2_forward` wrote it before the op, inline."""
    h = zxbcdt.shape[-1] - 2 * di - 2 * gn
    z, xc, B, C, dtr = torch.split(zxbcdt, [di, di, gn, gn, h], dim=-1)
    conv_in = torch.cat([xc, B, C], dim=-1)
    k = w.shape[0]
    state = torch.zeros((conv_in.shape[0], k - 1, conv_in.shape[2]),
                        dtype=conv_in.dtype)
    full = torch.cat([state, conv_in], dim=1)
    t = conv_in.shape[1]
    y = sum(full[:, j:j + t, :] * w[j] for j in range(k)) + b
    return z, F.silu(y).float(), F.softplus(dtr.float() + dt_bias.float())


def _inputs(bsz, t, di, gn, h, k=4, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = di + 2 * gn
    z = lambda *s: torch.randn(s, generator=g).to(dtype)  # noqa: E731
    return (z(bsz, t, 2 * di + 2 * gn + h), z(k, c) * 0.5, z(c) * 0.1,
            z(h))


# mamba2-2.7b's and zamba2-2.7b's widths (C 5,376 and 5,248, H 80), the
# reduced configs' (C 160, H 8), B > 1, T < K, odd C
CASES = [(2, 9, 5120, 128, 80), (1, 5, 5120, 64, 80), (3, 32, 128, 16, 8),
         (2, 2, 128, 16, 8), (2, 1, 37, 5, 3), (1, 45, 102, 3, 4)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bsz,t,di,gn,h", CASES)
def test_plain_version_is_the_eager_chain_bit_for_bit(bsz, t, di, gn, h,
                                                      dtype):
    args = _inputs(bsz, t, di, gn, h, dtype=dtype)
    got = ops.ssm_conv(*args, d_inner=di, gn=gn)
    want = _eager_chain(*args, di, gn)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert got[0].data_ptr() == args[0].data_ptr()       # z is a view


@pytest.fixture
def no_kernel(monkeypatch):
    """Replace the kernel's wrapper by one that records calls and fails."""
    calls = []

    def refuse(*a, **k):
        calls.append(a)
        raise AssertionError("the kernel was called")

    monkeypatch.setattr(kernel, "ssm_conv_fwd", refuse)
    return calls


@pytest.fixture
def op_calls(monkeypatch):
    calls = []
    real = ops.ssm_conv

    def spy(*a, **k):
        calls.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr(ops, "ssm_conv", spy)
    return calls


@pytest.fixture(scope="module")
def layer():
    cfg = reduced_config("mamba2-2.7b")
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, model.layers[0].ssm


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
    `conv_chain` and never the kernel, on a CUDA tensor too, and the
    gradients reach the layer's weights; otherwise a CUDA tensor goes to
    the kernel wrapper, once.  The model calls the op once a layer either
    way, and the values agree."""
    cfg, p = layer
    chain = []
    real = ops.conv_chain

    def spy(*a):
        chain.append(a[0])
        return real(*a)

    monkeypatch.setattr(ops, "conv_chain", spy)
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    with torch.set_grad_enabled(grad):
        y = ssm.mamba2_forward(p, cfg, x)
    assert len(op_calls) == len(chain) == 1 and chain[0] is op_calls[0]
    assert not no_kernel
    assert y.requires_grad == grad
    if grad:
        y.sum().backward()
        assert p.conv_w.grad is not None and p.dt_bias.grad is not None
        p.zero_grad(set_to_none=True)
        with torch.no_grad():
            torch.testing.assert_close(ssm.mamba2_forward(p, cfg, x),
                                       y.detach(), rtol=0, atol=0)
    route = []
    monkeypatch.setattr(ops, "conv_chain",
                        lambda *a: route.append("plain") or a[:3])
    monkeypatch.setattr(kernel, "ssm_conv_fwd",
                        lambda *a, **k: route.append("kernel") or a[:2])
    card = [v.as_subclass(_OnCard).requires_grad_(True)
            for v in _inputs(1, 4, 16, 4, 2)]
    with torch.set_grad_enabled(grad):
        ops.ssm_conv(*card, d_inner=16, gn=4)
    assert route == (["plain"] if grad else ["kernel"])


def test_decode_keeps_its_own_conv(layer, op_calls, no_kernel):
    """Decode (T = 1 with a state) never calls the op; its conv state is
    the last K - 1 inputs."""
    cfg, p = layer
    state = ssm.mamba2_init_state(cfg, 2, torch.float32)
    x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    with torch.no_grad():
        ssm.mamba2_decode(p, cfg, x, state)
    assert not op_calls and not no_kernel
    xbc = ref.split_proj(x @ p.in_proj, cfg.d_inner,
                         cfg.ssm_ngroups * cfg.d_state)
    assert torch.equal(state["conv"][:, -1],
                       torch.cat(xbc[1:4], dim=-1)[:, 0].detach())


@pytest.mark.parametrize("shard", ["batch", "batch and channels"])
def test_a_dtensor_runs_the_op_on_local_shards(no_kernel, monkeypatch,
                                               shard):
    """On a one-rank mesh, under `implicit_replication` as the sharded
    steps run: the op runs on each rank's local tensors (here the plain
    version, for CPU tensors; never on a DTensor), keeps a batch shard,
    replicates a shard of zxbcdt's last dim, and returns DTensors equal to
    the chain on the local tensors.  Across ranks:
    tests/test_torch_parallel.py's sharded prefill."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import make_mesh
    seen = []
    real = ops.conv_chain

    def spy(*a):
        seen.append(type(a[0]))
        return real(*a)

    monkeypatch.setattr(ops, "conv_chain", spy)
    args = _inputs(2, 8, 128, 16, 8)
    placements = {"batch": [Shard(0), Replicate()],
                  "batch and channels": [Shard(0), Shard(2)]}[shard]
    with dryrun.fake_world(1), implicit_replication():
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        dz = DTensor.from_local(args[0], mesh, placements)
        got = ops.ssm_conv(dz, *args[1:], d_inner=128, gn=16)
        assert all(isinstance(v, DTensor) and tuple(v.placements)
                   == (Shard(0), Replicate()) for v in got)
        local = [v.to_local() for v in got]
    assert seen == [torch.Tensor]
    for a, b in zip(local, ref.conv_chain(*args, 128, 16)):
        assert torch.equal(a, b)
    assert not no_kernel


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
    z, w, b, dtb = _inputs(1, 4, 16, 4, 2)
    return {"fp16": ((z.half(), w.half(), b.half(), dtb.half()), "one type"),
            "mixed": ((z, w.float(), b, dtb), "one type"),
            "K=5": ((z, torch.zeros(5, 24, dtype=z.dtype), b, dtb),
                    "K=5"),
            "K=1": ((z, w[:1], b, dtb), "K=1"),
            "K=3": ((z, w[:3].contiguous(), b, dtb), "K=3"),
            "width": ((z[..., :-1], w, b, dtb), "disagree"),
            "2-D": ((z[0], w, b, dtb), "takes zxbcdt"),
            "w not contiguous": ((z, w.t().contiguous().t(), b, dtb),
                                 "contiguous"),
            "cpu": ((z, w, b, dtb), "no ssm_conv kernel for device")}[case]


@pytest.mark.parametrize("case", ["fp16", "mixed", "K=5", "K=1", "K=3",
                                  "width", "2-D", "w not contiguous", "cpu"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, match = _refusal(case)
    before = dict(kernel.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        kernel.ssm_conv_fwd(*args, d_inner=16, gn=4)
    assert kernel.LAUNCHES == before


def test_wrapper_refuses_a_strided_last_dim():
    z, w, b, dtb = _inputs(1, 4, 16, 4, 2)
    wide = torch.zeros(1, 4, 2 * z.shape[2], dtype=z.dtype)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        kernel.check_inputs(wide, w, b, dtb, d_inner=16, gn=4)


@pytest.mark.parametrize("dtype,cols,di,gn,offset,shape,want", [
    # mamba2's and zamba2's layouts, contiguous: 16-byte accesses
    (torch.bfloat16, 10576, 5120, 128, 0, (2, 8), True),
    (torch.bfloat16, 10448, 5120, 64, 0, (2, 8), True),
    (torch.float32, 10576, 5120, 128, 0, (2, 8), True),
    # the conv's first column off a 16-byte boundary
    (torch.bfloat16, 16 + 2 * 12 + 3, 12, 6, 0, (1, 4), False),
    # a row stride that is not a multiple of 16 bytes
    (torch.bfloat16, 2 * 16 + 2 * 4 + 3, 16, 4, 0, (1, 4), False),
    # ... which does not matter for a single row
    (torch.bfloat16, 2 * 16 + 2 * 4 + 3, 16, 4, 0, (1, 1), True),
    # C = 24 + 2 = 26 channels: float32 output rows off 16 bytes
    (torch.bfloat16, 2 * 24 + 2 * 1 + 6, 24, 1, 0, (1, 4), False),
    # a view starting one element in
    (torch.bfloat16, 10576, 5120, 128, 1, (2, 8), False),
    # the reduced mamba2 at heads of 64 (tests/test_torch_ssd_gpu.py): H 2,
    # float32 rows of 514 columns, 2,056 bytes
    (torch.float32, 514, 128, 128, 0, (2, 8), False),
])
def test_vector_rule(dtype, cols, di, gn, offset, shape, want):
    buf = torch.zeros(shape[0] * shape[1] * cols + offset, dtype=dtype)
    z = buf[offset:].view(*shape, cols)
    assert kernel.vector_ok(z, d_inner=di, gn=gn) is want
