"""The RMS-norm op (`repro_torch.kernels.rms_norm`) on the CPU: its plain
version equals the eager chain `models/layers.py::rms_norm` ran inline
before the op, bit for bit; `layers.rms_norm` and every model norm route
through the op; the op sends a forward recorded by autograd to the plain
chain (never the kernel), with the old chain's gradients, CPU and meta
tensors to the plain chain, other tensors to the kernel wrapper, and a
DTensor's local shards through itself; the wrapper's checks, its
16-byte-access rule and its row views run here.  The kernel itself runs on
the card (tests/test_torch_rms_norm_gpu.py); the norm against the JAX
package is tests/test_torch_models.py::test_rms_norm.  No JAX here."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels.rms_norm import kernel, ops, ref
from repro_torch.launch import dryrun
from repro_torch.models import forward, init_model, layers

BF16, F32 = torch.bfloat16, torch.float32


def _old_chain(x, weight, eps=1e-5):
    """`layers.rms_norm` as it was written before the op, inline."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dtype)


def _inputs(shape, dtype=BF16, wdtype=None, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 3
    w = 1 + 0.1 * torch.randn(shape[-1], generator=g)
    return x.to(device, dtype), w.to(device, wdtype or dtype)


@pytest.mark.parametrize("dtype,wdtype", [(BF16, BF16), (F32, F32),
                                          (BF16, F32), (F32, BF16)])
@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 2560), (1, 1, 3072),
                                   (2, 3, 4, 33), (7,)])
def test_plain_version_is_the_old_chain_bit_for_bit(shape, dtype, wdtype):
    x, w = _inputs(shape, dtype, wdtype)
    want = _old_chain(x, w)
    for got in (ref.rms_norm(x, w, 1e-5), ops.rms_norm(x, w, 1e-5),
                layers.rms_norm(x, w), layers.norm(
                    x, type("P", (), {"scale": w})(), "rmsnorm")):
        assert got.dtype == dtype and got.shape == x.shape
        assert torch.equal(got, want)


@pytest.fixture
def no_kernel(monkeypatch):
    """Replace the kernel's wrapper by one that records calls and fails."""
    calls = []

    def refuse(*a, **k):
        calls.append(a)
        raise AssertionError("the kernel was called")

    monkeypatch.setattr(kernel, "rms_norm_fwd", refuse)
    return calls


@pytest.fixture
def op_calls(monkeypatch):
    """Every call of the op, by the width it norms."""
    calls = []
    real = ops.rms_norm

    def spy(x, weight, eps):
        calls.append(x.shape[-1])
        return real(x, weight, eps)

    monkeypatch.setattr(ops, "rms_norm", spy)
    return calls


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-2.7b",
                                  "deepseek-v2-lite-16b", "minicpm3-4b",
                                  "zamba2-2.7b"])
def test_every_model_norm_goes_through_the_op(arch, op_calls, no_kernel):
    """A prefill calls the op once a residual-stream norm and the final
    norm (2 a block, 1 a Mamba2 block), and once for each of MLA's latent
    norms (kv_a, and q_a where the config has a q_lora_rank); the Mamba2
    gate's norm stays inside the gate op."""
    cfg = reduced_config(arch)
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        forward(model, cfg, {"tokens": tokens})
    n, d = cfg.n_layers, cfg.d_model
    want = {"smollm-135m": [d] * (2 * n + 1),
            "mamba2-2.7b": [d] * (n + 1),
            "deepseek-v2-lite-16b": [d, cfg.kv_lora_rank, d] * n + [d],
            "minicpm3-4b": [d, cfg.q_lora_rank, cfg.kv_lora_rank, d] * n
            + [d]}.get(arch)
    if want is None:                  # zamba2: Mamba2 and shared blocks
        assert op_calls.count(d) == len(op_calls) >= n + 1
    else:
        assert op_calls == want
    assert not no_kernel


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_chip_smokes_norm_count_is_the_models(arch, op_calls, no_kernel):
    """`chip_smoke.norm_launches`, which the card's prefill checks hold the
    kernel's counter to, counts the op's calls in a prefill of every
    registered family (reduced; whisper's norms are layer norms)."""
    smoke = _chip_smoke()
    cfg = reduced_config(arch)
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16),
                                     generator=torch.Generator().manual_seed(1))}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros(2, 16, cfg.d_model)
    with torch.no_grad():
        forward(model, cfg, batch)
    assert len(op_calls) == smoke.norm_launches(cfg)
    assert not no_kernel


class _OnCard(torch.Tensor):
    """A CPU tensor whose device reads CUDA: it takes the op's route to the
    kernel wrapper (stubbed below) on a host without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("grad", ["x", "weight", None])
def test_grad_mode_picks_the_path(monkeypatch, grad):
    """While autograd records a gradient through x or the weight, the op
    calls the plain chain, never the kernel, on a CUDA tensor too, and the
    gradients equal the old chain's bit for bit; otherwise a CUDA tensor
    goes to the kernel wrapper, once."""
    x, w = _inputs((2, 8, 64), F32)
    if grad:
        {"x": x, "weight": w}[grad].requires_grad_(True)
        got = ops.rms_norm(x, w, 1e-5)
        got.square().sum().backward()
        mine = [t.grad.clone() for t in (x, w) if t.grad is not None]
        for t in (x, w):
            t.grad = None
        _old_chain(x, w).square().sum().backward()
        old = [t.grad for t in (x, w) if t.grad is not None]
        assert len(mine) == len(old) == 1
        assert torch.equal(mine[0], old[0])
    route = []
    monkeypatch.setattr(ref, "rms_norm",
                        lambda x, w, eps: route.append("plain") or x)
    monkeypatch.setattr(kernel, "rms_norm_fwd",
                        lambda x, w, eps: route.append("kernel") or x)
    card = [v.detach().as_subclass(_OnCard) for v in (x, w)]
    if grad:
        card[0 if grad == "x" else 1].requires_grad_(True)
    ops.rms_norm(*card, 1e-5)
    with torch.no_grad():
        ops.rms_norm(*card, 1e-5)
    assert route == (["plain", "kernel"] if grad else ["kernel", "kernel"])


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_op_sends_cpu_and_meta_tensors_to_the_plain_chain(no_kernel,
                                                          monkeypatch,
                                                          device):
    seen = []
    real = ref.rms_norm
    monkeypatch.setattr(ref, "rms_norm", lambda *a: seen.append(
        a[0].device.type) or real(*a))
    x, w = _inputs((2, 4, 64), device=device)
    with torch.no_grad():
        out = ops.rms_norm(x, w, 1e-5)
    assert seen == [device] and not no_kernel
    assert out.device.type == device and out.shape == (2, 4, 64)


@pytest.mark.parametrize("shard", ["batch", "batch and sequence",
                                   "batch and normed dim"])
def test_a_dtensor_runs_the_op_on_local_shards(no_kernel, monkeypatch,
                                               shard):
    """On a one-rank mesh, under `implicit_replication` as the sharded
    steps run: the op runs on the rank's local tensor (the plain version
    here, for CPU tensors; never on a DTensor), keeps batch and sequence
    shards, replicates a shard of the normed dim, and returns a DTensor
    equal to the plain chain on the local tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import make_mesh
    seen = []
    real = ref.rms_norm
    monkeypatch.setattr(ref, "rms_norm", lambda *a: seen.append(
        type(a[0])) or real(*a))
    x, w = _inputs((2, 8, 64))
    pl, out = {"batch": ([Shard(0), Replicate()], [Shard(0), Replicate()]),
               "batch and sequence": ([Shard(0), Shard(1)],
                                      [Shard(0), Shard(1)]),
               "batch and normed dim": ([Shard(0), Shard(2)],
                                        [Shard(0), Replicate()])}[shard]
    with dryrun.fake_world(1), implicit_replication(), torch.no_grad():
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        got = ops.rms_norm(DTensor.from_local(x, mesh, pl), w, 1e-5)
        assert isinstance(got, DTensor)
        assert list(got.placements) == out
        local = got.to_local()
    assert seen == [torch.Tensor] and not no_kernel
    assert torch.equal(local, _old_chain(x, w))


# --------------------------------------------------------------------------
# the wrapper's rules (pure Python)
# --------------------------------------------------------------------------
def _refusal(case):
    x, w = _inputs((2, 4, 64))
    return {
        "0-D x": ((x[0, 0, 0], w), "takes x"),
        "2-D weight": ((x, w[None]), "takes x"),
        "weight length": ((x, w[:32]), "length"),
        "no width": ((x[..., :0], w[:0]), "outside"),
        "too wide": ((torch.zeros(1, kernel.MAX_D + 8, dtype=BF16),
                      torch.zeros(kernel.MAX_D + 8, dtype=BF16)), "outside"),
        "fp16": ((x.half(), w.half()), "types"),
        "int weight": ((x, w.int()), "types"),
        "float32 weight": ((x, w.float()), "types"),
        "bf16 weight": ((x.float(), w), "types"),
        "bf16 d % 8": ((x[..., :60], w[:60]), "multiple of 8"),
        "float32 d % 4": ((x.float()[..., :62], w.float()[:62]),
                          "multiple of 4"),
        "device": ((x, w.to("meta")), "one device"),
        "x strided": ((torch.zeros(2, 4, 128, dtype=BF16)[..., ::2], w),
                      "unit stride"),
        "weight strided": ((x, torch.zeros(128, dtype=BF16)[::2]),
                           "contiguous"),
        "cpu": ((x, w), "no rms_norm kernel for device"),
    }[case]


@pytest.mark.parametrize("case", ["0-D x", "2-D weight", "weight length",
                                  "no width", "too wide", "fp16",
                                  "int weight", "float32 weight",
                                  "bf16 weight", "bf16 d % 8",
                                  "float32 d % 4", "device", "x strided",
                                  "weight strided", "cpu"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, match = _refusal(case)
    before = dict(kernel.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        kernel.rms_norm_fwd(*args, eps=1e-5)
    assert kernel.LAUNCHES == before


def _view(shape, dtype=BF16, offset=0, cols=None):
    """A [..., d] view of a fresh buffer `offset` elements in, in rows of
    `cols` (default d) columns."""
    cols = cols or shape[-1]
    n = 1
    for s in shape[:-1]:
        n *= s
    buf = torch.zeros(n * cols + offset, dtype=dtype)
    return buf[offset:].view(*shape[:-1], cols)[..., :shape[-1]]


@pytest.mark.parametrize("x,w,want", [
    # the cells' residual streams (phi3, mamba2, granite), bf16 and float32
    (_view((4, 1920, 3072)), torch.ones(3072, dtype=BF16), True),
    (_view((9, 896, 2560)), torch.ones(2560, dtype=BF16), True),
    (_view((2, 4096, 4096), F32), torch.ones(4096), True),
    # MLA's c_kv: rows of kv_lora_rank + qk_rope_dim (deepseek-v2-lite,
    # minicpm3, the reduced configs)
    (_view((2, 8, 512), cols=576), torch.ones(512, dtype=BF16), True),
    (_view((2, 8, 256), cols=288), torch.ones(256, dtype=BF16), True),
    (_view((2, 8, 32), F32, cols=40), torch.ones(32), True),
    # a start 8 bytes or 16 bytes in, rows of an odd stride (one row: no
    # stride to break the rule)
    (_view((2, 8, 64), offset=1), torch.ones(64, dtype=BF16), False),
    (_view((2, 8, 64), F32, offset=2), torch.ones(64), False),
    (_view((2, 8, 64), F32, offset=4), torch.ones(64), True),
    (_view((2, 8, 64), cols=65), torch.ones(64, dtype=BF16), False),
    (_view((1, 1, 64), cols=65), torch.ones(64, dtype=BF16), True),
    # the weight starting one element in
    (_view((2, 8, 64)), torch.ones(65, dtype=BF16)[1:], False),
    (_view((2, 8, 64), F32), torch.ones(65)[1:], False),
])
def test_vector_rule(x, w, want):
    assert kernel.vector_ok(x, w) is want


@pytest.mark.parametrize("shape,cols,want", [
    ((64,), 64, (1, 1, 64)),
    ((5, 64), 64, (1, 5, 64)),
    ((2, 5, 64), 64, (2, 5, 64)),
    ((2, 5, 64), 80, (2, 5, 64)),
    ((3, 2, 5, 64), 64, (6, 5, 64)),
    ((3, 2, 5, 64), 80, (6, 5, 64)),
])
def test_rows_are_a_view_of_x(shape, cols, want):
    """The kernel's [outer, inner, d] rows read x in place, at its own
    row strides (MLA's `c_kv` too), for any rank."""
    x = _view(shape, cols=cols)
    rows = kernel._rows(x)
    assert tuple(rows.shape) == want and rows.data_ptr() == x.data_ptr()
    assert rows.stride(-1) == 1
    if len(shape) > 1:
        assert rows.stride(1) == cols


def test_forward_launches_no_kernel_on_the_cpu():
    cfg = dataclasses.replace(reduced_config("smollm-135m"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = dict(kernel.LAUNCHES)
    with torch.no_grad():
        forward(model, cfg, {"tokens": torch.zeros(1, 8, dtype=torch.long)})
    assert kernel.LAUNCHES == before
