"""The readers of the RMS-norm kernel's metrics:
`rms_norm_fused_calls.prefill` on windows of host-clock readings (the
kernel's launches a call where the program counts them, nothing where it
has no such counter), and `rms_norm_roofline.prefill` on synthetic traces
(the residual stream's norm bytes over the kernel's device time, nothing
where the trace has no such kernel); the byte and norm counts of the three
configurations; and the kernel's name outside `elementwise_ms.prefill`'s."""
from __future__ import annotations

import pytest
from conftest import ROOT

from portbench import harness, roofline
from portbench.trace import Trace

NAME = "rms_norm_fused_calls.prefill"
ROOF = "rms_norm_roofline.prefill"
KERNEL = ("void (anonymous namespace)::rms_norm_kernel<__nv_bfloat16, "
          "__nv_bfloat16, true, 16>((anonymous namespace)::Args)")
PHI3, MAMBA2, GRANITE = ("phi3-mini-3.8b.conv-2k", "mamba2-2.7b.code-4k",
                         "granite-4.0-h-small.code-4k")
#: cell -> (norms a call, d_model)
NORMS = {PHI3: (65, 3072), MAMBA2: (65, 2560), GRANITE: (81, 4096)}


def _metric(name: str):
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


def _read(cell: str, counters: dict, calls: int = 4):
    c = harness.load_cell(ROOT, cell)
    w = harness.Window(latency_s=[0.25] * calls, enqueue_s=[0.2] * calls,
                       shapes=[(4, 2048)] * calls, seconds=0.25 * calls,
                       counters=counters)
    return c.readers[NAME](harness.Readings(c, 12.5, w))


@pytest.mark.parametrize("cell,counters,want", [
    (PHI3, {"rms_norm.fused": 260, "flash_attention.flash": 128}, 65),
    (MAMBA2, {"rms_norm.fused": 260, "ssm_gate.fused": 256}, 65),
    (GRANITE, {"rms_norm.fused": 324, "ssm_gate.fused": 144}, 81),
    (MAMBA2, {"rms_norm.fused": 0}, 0),
    (PHI3, {"flash_attention.flash": 128}, None),   # a program without it
    (GRANITE, {"ssm_gate.fused": 144}, None),
])
def test_reader_counts_launches_a_call(cell, counters, want):
    assert _read(cell, counters) == want


def test_reader_is_silent_without_calls():
    assert _read(MAMBA2, {"rms_norm.fused": 0}, 0) is None


@pytest.mark.parametrize("cell", [PHI3, MAMBA2, GRANITE])
def test_both_metrics_are_read_in_every_cell(cell):
    readers = harness.load_cell(ROOT, cell).readers
    assert NAME in readers and ROOF in readers


@pytest.mark.parametrize("cell", [PHI3, MAMBA2, GRANITE])
def test_roofline_bytes_by_norm(cell):
    """A norm at [4, 2048]: x read and the output written once in bf16, 4
    bytes a value a token, plus the bf16 weight once; 2 norms a block and
    the final one in phi3 and granite (all 40 of its layers, Mamba2 or
    attention), 1 a block and the final one in mamba2."""
    m = harness.load_cell(ROOT, cell).model
    mod = _metric(ROOF)
    norms, d = NORMS[cell]
    assert mod.norms_per_call(m) == norms
    assert mod.bytes_per_call(m, 4, 2048) == norms * (4 * 2048 * d * 4
                                                      + 2 * d)
    assert mod.norms_per_call(dict(m, norm="layernorm")) == 0


def _roof(cell, shapes, names, launches: int, launch_s: float):
    """The roofline reader on a trace of len(shapes) calls, each launching
    `launches` activities of each of `names` for `launch_s` seconds."""
    c = harness.load_cell(ROOT, cell)
    device, now = [], 0.0
    for _ in shapes:
        for _ in range(launches):
            for name in names:
                device.append((name, now, now + launch_s))
                now += launch_s
    trace = Trace(calls=len(shapes), device=device, host=[], t0=0.0,
                  t1=now + 1e-4)
    r = harness.Readings(c, 12.5, harness.Window(), trace, list(shapes))
    return c.readers[ROOF](r)


@pytest.mark.parametrize("cell", [PHI3, MAMBA2, GRANITE])
@pytest.mark.parametrize("shapes", [[(4, 2048)] * 2,
                                    [(9, 896), (2, 4096), (4, 2048)]])
def test_roofline_is_the_bound_over_the_kernels_time(cell, shapes):
    m = harness.load_cell(ROOT, cell).model
    mod = _metric(ROOF)
    launches = NORMS[cell][0]
    bound_s = sum(mod.bytes_per_call(m, b, s) for b, s in shapes) \
        / roofline.HBM_BYTES_PER_S / len(shapes)
    # each launch at 1.25 times its share of the bound: 80%, whatever
    # other kernels run beside it
    share = _roof(cell, shapes,
                  [KERNEL, "ssm_gate_kernel", "elementwise_kernel"],
                  launches, 1.25 * bound_s / launches)
    assert share == pytest.approx(80.0)


@pytest.mark.parametrize("cell", [PHI3, MAMBA2, GRANITE])
def test_roofline_is_silent_without_the_kernel(cell):
    assert _roof(cell, [(4, 2048)], ["elementwise_kernel"], 65,
                 1e-5) is None
    c = harness.load_cell(ROOT, cell)
    assert c.readers[ROOF](harness.Readings(c, 12.5, harness.Window())) \
        is None


@pytest.mark.parametrize("name", [
    KERNEL,
    "void (anonymous namespace)::rms_norm_kernel<float, float, false, 32>"
    "((anonymous namespace)::Args)"])
def test_kernel_time_leaves_elementwise_ms(name):
    ew = _metric("elementwise_ms.prefill")
    assert not ew.is_elementwise(name)
    assert ew.is_elementwise("void at::native::elementwise_kernel<128, 2>")
