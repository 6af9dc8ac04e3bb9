"""The readers of the Mamba2 gate-chain kernel's metrics:
`ssm_gate_fused_calls.prefill` on windows of host-clock readings (the
kernel's launches a call where the program counts them, nothing where it
has no such counter, nothing in a cell without it), and
`ssm_gate_roofline.prefill` on synthetic traces (the bytes' bound over the
kernel's device time, by Mamba2 layer as `layer_types` counts them,
nothing where the trace has no such kernel); and the kernel's name outside
`elementwise_ms.prefill`'s."""
from __future__ import annotations

import pytest
from conftest import ROOT

from portbench import harness, roofline
from portbench.trace import Trace

NAME = "ssm_gate_fused_calls.prefill"
ROOF = "ssm_gate_roofline.prefill"
KERNEL = ("void (anonymous namespace)::ssm_gate_kernel<__nv_bfloat16, "
          "1>((anonymous namespace)::Args)")
MAMBA2, GRANITE = "mamba2-2.7b.code-4k", "granite-4.0-h-small.code-4k"


def _metric(name: str):
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


def _read(cell: str, counters: dict, calls: int = 4):
    c = harness.load_cell(ROOT, cell)
    w = harness.Window(latency_s=[0.25] * calls, enqueue_s=[0.2] * calls,
                       shapes=[(4, 2048)] * calls, seconds=0.25 * calls,
                       counters=counters)
    r = harness.Readings(c, 12.5, w)
    return c.readers[NAME](r) if NAME in c.readers else "no reader"


@pytest.mark.parametrize("cell,counters,want", [
    (MAMBA2, {"ssm_gate.fused": 256, "ssm_conv.fused": 256}, 64),
    (GRANITE, {"ssm_gate.fused": 144, "ssm_conv.fused": 144}, 36),
    (MAMBA2, {"ssm_gate.fused": 0}, 0),
    (MAMBA2, {"ssm_conv.fused": 256}, None),   # a program without it
    (GRANITE, {"ssm_conv.fused": 144}, None),
])
def test_reader_counts_launches_a_call(cell, counters, want):
    assert _read(cell, counters) == want


def test_reader_is_silent_without_calls():
    assert _read(MAMBA2, {"ssm_gate.fused": 0}, 0) is None


def test_phi3_cell_has_no_such_metric():
    assert _read("phi3-mini-3.8b.conv-2k", {}) == "no reader"
    c = harness.load_cell(ROOT, "phi3-mini-3.8b.conv-2k")
    assert ROOF not in c.readers


@pytest.mark.parametrize("cell,layers,di,h", [(MAMBA2, 64, 5120, 80),
                                              (GRANITE, 36, 8192, 128)])
def test_roofline_bytes_by_mamba2_layer(cell, layers, di, h):
    """A layer at [4, 2048]: y and xh in float32 and z and the output in
    bf16 each once, 12 bytes a channel a token, plus out_norm and D in
    bf16; granite counts its 36 Mamba2 layers by `layer_types`, not its
    40 layers."""
    m = harness.load_cell(ROOT, cell).model
    mod = _metric(ROOF)
    assert mod.mamba_layers(m) == layers
    layer = 4 * 2048 * di * 12 + (di + h) * 2
    assert mod.bytes_per_call(m, 4, 2048) == layers * layer
    assert mod.bytes_per_call({"d_model": 8}, 4, 2048) == 0


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


@pytest.mark.parametrize("cell,launches", [(MAMBA2, 64), (GRANITE, 36)])
@pytest.mark.parametrize("shapes", [[(4, 2048)] * 2,
                                    [(9, 896), (2, 4096), (4, 2048)]])
def test_roofline_is_the_bound_over_the_kernels_time(cell, launches,
                                                     shapes):
    m = harness.load_cell(ROOT, cell).model
    mod = _metric(ROOF)
    bound_s = sum(mod.bytes_per_call(m, b, s) for b, s in shapes) \
        / roofline.HBM_BYTES_PER_S / len(shapes)
    # each launch at 1.25 times its share of the bound: 80%, whatever
    # other kernels run beside it
    share = _roof(cell, shapes,
                  [KERNEL, "ssm_conv_kernel", "elementwise_kernel"],
                  launches, 1.25 * bound_s / launches)
    assert share == pytest.approx(80.0)


@pytest.mark.parametrize("cell", [MAMBA2, GRANITE])
def test_roofline_is_silent_without_the_kernel(cell):
    assert _roof(cell, [(4, 2048)], ["ssm_conv_kernel"], 36, 1e-4) is None
    c = harness.load_cell(ROOT, cell)
    r = harness.Readings(c, 12.5, harness.Window())
    assert c.readers[ROOF](r) is None


@pytest.mark.parametrize("name", [
    KERNEL,
    "void (anonymous namespace)::ssm_gate_kernel<float, 2>"
    "((anonymous namespace)::Args)"])
def test_kernel_time_leaves_elementwise_ms(name):
    ew = _metric("elementwise_ms.prefill")
    assert not ew.is_elementwise(name)
    assert ew.is_elementwise("void at::native::elementwise_kernel<128, 2>")
