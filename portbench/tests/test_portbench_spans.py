"""Device time by the program's spans (`spans.py`): the attribution of
each device activity to the innermost span open at its launch, on
synthetic event lists, the stretch's sums and idle-gap names on a
synthetic trace, and one profiled stretch of a tiny cell on the CPU."""
from __future__ import annotations

import pytest
import torch

from portbench import harness, spans
from portbench.trace import Trace

#: the program's span names the synthetic lists use
PROGRAM = {"model.forward", "model.block", "norm", "attn", "attn.core"}

#: one call's host ranges on the calling thread: the harness's range, the
#: program's spans and two ATen operators (seconds)
RANGES = [("portbench.call", 0.0, 100.0), ("model.forward", 1.0, 99.0),
          ("model.block", 2.0, 50.0), ("norm", 3.0, 10.0),
          ("aten::mul", 4.0, 9.0), ("attn", 10.0, 40.0),
          ("attn.core", 30.0, 38.0), ("aten::add", 44.0, 46.0),
          ("portbench.readback", 100.0, 130.0),
          ("aten::copy_", 118.0, 125.0)]


def test_each_kernel_lands_in_the_span_open_at_its_launch():
    launches = {1: 5.0,       # inside aten::mul under norm
                2: 33.0,      # a ctypes launch: no op, under attn.core
                3: 120.0,     # the logits' copy, outside every span
                4: 45.0}      # the residual add: model.block's own
    acts = [("elementwise_kernel", 6.0, 7.0, 1),
            ("flash_fwd_tc_kernel", 34.0, 40.0, 2),
            ("Memcpy DtoH", 121.0, 122.0, 3),
            ("elementwise_kernel", 46.0, 47.0, 4),
            ("unrecorded launch", 50.0, 51.0, 99)]
    got = spans.attribute(RANGES, launches, acts, PROGRAM.__contains__)
    assert got == ["norm", "attn.core", None, "model.block", None]
    assert spans.attribute(RANGES, launches, acts,
                           "portbench.call".__eq__) == \
        ["portbench.call", "portbench.call", None, "portbench.call", None]


def test_innermost_takes_the_inner_of_equal_starts_and_half_open_ends():
    ranges = [("b", 5.0, 10.0), ("outer", 0.0, 10.0), ("a", 0.0, 5.0),
              ("a.1", 1.0, 2.0)]
    times = [10.0, 0.0, 5.0, 1.5, 2.0, 9.9, -1.0]
    assert spans.innermost(ranges, times) == \
        [None, "a", "b", "a.1", "a", "b", None]
    assert spans.innermost([], [1.0]) == [None]
    assert spans.innermost(ranges, []) == []


def _stretch():
    """Two calls after a lead call, 10 ms apart, each: a norm kernel (1 ms),
    a flash kernel (2 ms) and a residual add (1 ms), then the logits' copy
    (0.1 ms).  The device idles while the host is in norm's aten::mul (the
    first call's first ms), in attn (1 ms a call) and in the readback
    (the rest, with the second call's first ms)."""
    device, owners, in_call, host, sp, ops = [], [], [], [], [], []
    for c in range(3):                       # call 0 is the lead call
        t = c * 0.010
        device += [("elementwise_kernel", t + 0.001, t + 0.002),
                   ("flash_fwd_tc_kernel", t + 0.003, t + 0.005),
                   ("elementwise_kernel add", t + 0.005, t + 0.006),
                   ("Memcpy DtoH", t + 0.007, t + 0.0071)]
        owners += ["norm", "attn.core", "model.block", None]
        in_call += [True, True, True, False]
        host += [("portbench.call", t, t + 0.0065),
                 ("portbench.readback", t + 0.0065, t + 0.010)]
        sp += [("model.forward", t + 0.0001, t + 0.0064),
               ("norm", t + 0.0002, t + 0.0006),
               ("attn", t + 0.0006, t + 0.0030),
               ("attn.core", t + 0.0028, t + 0.0030)]
        ops += [("aten::mul", t + 0.0003, t + 0.0008)]
    t0 = 0.010
    keep = [i for i, d in enumerate(device) if d[2] > t0]
    trace = Trace(calls=2, device=[device[i] for i in keep], host=host + sp,
                  t0=t0, t1=0.030)
    return spans.Stretch(trace=trace, owners=[owners[i] for i in keep],
                         in_call=[in_call[i] for i in keep], spans=sp,
                         ops=ops, enqueue_s=[0.0064, 0.0064], unlaunched=0)


def test_stretch_sums_device_time_by_span():
    st = _stretch()
    by = st.ms_by_span()
    assert by == pytest.approx({"attn.core": 2.0, "norm": 1.0,
                                "model.block": 1.0, "(none)": 0.1})
    assert list(by)[0] == "attn.core"
    flash = st.ms_of(lambda n: "flash_" in n)
    assert flash == pytest.approx(2.0)
    assert st.ms_of(lambda n: "flash_" in n, "attn.core") == flash
    assert st.ms_of(lambda n: "flash_" in n, "attn") == 0.0
    assert st.attributed_share() == pytest.approx(1.0)
    st.owners[0] = None
    assert st.attributed_share() == pytest.approx(7 / 8)


def test_idle_gaps_name_the_span_and_op_the_host_was_in():
    st = _stretch()
    gaps = st.idle_gaps()
    assert gaps == pytest.approx({"portbench.call/norm/aten::mul": 0.001,
                                  "portbench.call/attn": 0.002,
                                  "portbench.readback": 0.0088})
    assert sum(gaps.values()) == pytest.approx(st.trace.window_s
                                               - st.trace.busy_s)
    st.trace.device.append(("short", 0.02099, 0.020995))
    st.trace.device.sort(key=lambda d: d[1])
    gaps = st.idle_gaps()
    assert gaps["gaps under 20 us"] == pytest.approx(5e-6)
    assert gaps["portbench.readback"] == pytest.approx(0.0088 - 1e-5)


def test_a_tiny_cell_profiled_with_spans_on_the_cpu(tiny_root):
    from repro_torch.obs import NULL_TRACER, MODEL_SPANS, Tracer
    cell = harness.load_cell(tiny_root, "tiny-ssm.tiny")
    _, call, _ = harness.set_up(cell, 2 ** 33 + 5, torch.device("cpu"))
    traced = harness.prompts(7, cell.traffic, cell.config["token_ids"],
                             "traced")
    tokens = [traced(i) for i in range(len(harness.schedule(cell.traffic)))]
    shapes = [tuple(t.shape) for t in tokens]
    off = spans.profile_stretch(call, tokens, NULL_TRACER)
    on = spans.profile_stretch(call, tokens, Tracer())
    assert off.spans == [] and off.trace.device == []
    assert on.unlaunched == off.unlaunched == 0
    assert {s[0] for s in on.spans} == {
        "model.forward", "model.embed", "model.block", "norm", "ssm",
        "ssm.conv", "ssm.scan", "ssm.gate", "model.head"}
    assert {s[0] for s in on.spans} <= set(MODEL_SPANS)
    assert sum(s[0] == "model.forward" for s in on.spans) == len(tokens) + 1
    assert len(on.enqueue_s) == len(tokens)
    line = spans.report(cell, on, "on", shapes)
    assert line["ms_by_span"] == {} and line["attributed_share"] is None
    assert line["spans_a_call"] == len(on.spans) / (len(tokens) + 1)
    assert spans.report(cell, off, "off", shapes)["metrics"] == {}
