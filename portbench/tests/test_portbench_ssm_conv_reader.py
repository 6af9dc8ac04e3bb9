"""The readers of the Mamba2 conv-chain kernel's metrics:
`ssm_conv_fused_calls.prefill` on windows of host-clock readings (the
kernel's launches a call where the program counts them, nothing where it
has no such counter, nothing in a cell without it), and
`ssm_conv_roofline.prefill` on synthetic traces (the bytes' bound over the
kernel's device time, nothing where the trace has no such kernel)."""
from __future__ import annotations

import pytest
from conftest import ROOT

from portbench import harness, roofline
from portbench.trace import Trace

NAME = "ssm_conv_fused_calls.prefill"
ROOF = "ssm_conv_roofline.prefill"
KERNEL = ("void (anonymous namespace)::ssm_conv_kernel<__nv_bfloat16, "
          "true>((anonymous namespace)::Args)")


def _read(cell: str, counters: dict, calls: int = 4):
    c = harness.load_cell(ROOT, cell)
    w = harness.Window(latency_s=[0.25] * calls, enqueue_s=[0.2] * calls,
                       shapes=[(4, 2048)] * calls, seconds=0.25 * calls,
                       counters=counters)
    r = harness.Readings(c, 12.5, w)
    return c.readers[NAME](r) if NAME in c.readers else "no reader"


@pytest.mark.parametrize("counters,want", [
    ({"ssm_conv.fused": 256, "ssd_scan.ssd_tc": 256}, 64),
    ({"ssm_conv.fused": 0}, 0),
    ({"ssd_scan.ssd_tc": 256}, None),          # a program without the kernel
])
def test_reader_counts_launches_a_call(counters, want):
    assert _read("mamba2-2.7b.code-4k", counters) == want


def test_reader_is_silent_without_calls():
    assert _read("mamba2-2.7b.code-4k", {"ssm_conv.fused": 0}, 0) is None


def test_phi3_cell_has_no_such_metric():
    assert _read("phi3-mini-3.8b.conv-2k", {}) == "no reader"
    c = harness.load_cell(ROOT, "phi3-mini-3.8b.conv-2k")
    assert ROOF not in c.readers


def _roof(shapes, names, launch_s: float):
    """The roofline reader on a trace of len(shapes) calls, each launching
    64 activities of each of `names` for `launch_s` seconds."""
    c = harness.load_cell(ROOT, "mamba2-2.7b.code-4k")
    device, now = [], 0.0
    for _ in shapes:
        for _ in range(64):
            for name in names:
                device.append((name, now, now + launch_s))
                now += launch_s
    trace = Trace(calls=len(shapes), device=device, host=[], t0=0.0,
                  t1=now + 1e-4)
    r = harness.Readings(c, 12.5, harness.Window(), trace, list(shapes))
    return c.readers[ROOF](r)


def test_roofline_bytes_at_mamba2_layer():
    """mamba2-2.7b's layer at [4, 2048]: C 5,376 and H 80 columns, bf16
    in and float32 out, plus the weights (5 C + H) in bf16."""
    m = harness.load_cell(ROOT, "mamba2-2.7b.code-4k").model
    mod = harness.load_module(ROOT / "portbench" / "metrics"
                              / f"{ROOF}.py")
    layer = 4 * 2048 * 5456 * 6 + (5 * 5376 + 80) * 2
    assert mod.bytes_per_call(m, 4, 2048) == 64 * layer
    assert mod.bytes_per_call({"d_model": 8}, 4, 2048) == 0


@pytest.mark.parametrize("shapes", [[(4, 2048)] * 2,
                                    [(9, 896), (2, 4096), (4, 2048)]])
def test_roofline_is_the_bound_over_the_kernels_time(shapes):
    m = harness.load_cell(ROOT, "mamba2-2.7b.code-4k").model
    mod = harness.load_module(ROOT / "portbench" / "metrics"
                              / f"{ROOF}.py")
    bound_s = sum(mod.bytes_per_call(m, b, s) for b, s in shapes) \
        / roofline.HBM_BYTES_PER_S / len(shapes)
    # each launch at 1.5 times its share of the bound: 66.7%, whatever
    # other kernels run beside it
    share = _roof(shapes, [KERNEL, "ssd_out_kernel", "elementwise_kernel"],
                  1.5 * bound_s / 64)
    assert share == pytest.approx(100 / 1.5)


def test_roofline_is_silent_without_the_kernel():
    assert _roof([(4, 2048)], ["ssd_out_kernel"], 1e-4) is None
    c = harness.load_cell(ROOT, "mamba2-2.7b.code-4k")
    r = harness.Readings(c, 12.5, harness.Window())
    assert c.readers[ROOF](r) is None
