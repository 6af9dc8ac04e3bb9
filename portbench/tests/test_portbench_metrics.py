"""The metric readers on a recorded profiler table (the device activities
of four profiled prefills of one shape on the H100,
`data/profile_table.json`) laid out as a trace, and on a window of
host-clock readings."""
from __future__ import annotations

import json
import statistics

import pytest
import torch
from conftest import ROOT

from portbench import harness, roofline
from portbench.trace import Trace, profile_calls

DENSE = harness.load_module(ROOT / "portbench" / "roofline" / "dense.py")

TABLE = json.loads((ROOT / "portbench" / "tests" / "data"
                    / "profile_table.json").read_text())


CELLS = {"phi3-mini-3.8b": "phi3-mini-3.8b.conv-2k",
         "mamba2-2.7b": "mamba2-2.7b.code-4k"}


def _trace(cell: str, drop=(), gap: float = 1e-4) -> Trace:
    """The table's activities as `calls` calls on one timeline: each call
    its share of every activity back to back, the logits' copy last, then
    an idle `gap`; `drop`: (call, name part) launches left unrecorded."""
    t = TABLE[cell]
    n = t["calls"]
    acts = [(name, c, s / c) for name, c, s in t["activities"]]
    readback = [a for a in acts if a[0].startswith("Memcpy DtoH")]
    rest = [a for a in acts if not a[0].startswith("Memcpy DtoH")]
    device, host, now = [], [], 0.0
    pending = list(drop)
    for call in range(n):
        start = now
        for name, count, dur in rest + readback:
            for _ in range(count // n + (call < count % n)):
                hit = [d for d in pending
                       if d[0] == call and name.startswith(d[1])]
                if hit:
                    pending.remove(hit[0])
                    continue
                device.append((name, now, now + dur))
                now += dur
        host.append(("portbench.call", start, start + 1e-3))
        host.append(("portbench.readback", now - 1e-5, now + gap))
        now += gap
    return Trace(calls=n, device=device, host=host, t0=0.0, t1=now)


def _readings(config: str, trace=None, **window):
    """Readings of `config`'s cell; a trace is of the table's calls."""
    cell = harness.load_cell(ROOT, CELLS[config])
    shapes = [tuple(TABLE[config]["shape"])] * TABLE[config]["calls"] \
        if trace is not None else []
    return harness.Readings(cell, 12.5, harness.Window(**window), trace,
                            shapes)


def _per_call_ms(cell: str, match) -> float:
    t = TABLE[cell]
    return sum(s for name, _, s in t["activities"] if match(name)) \
        / t["calls"] * 1e3


def test_device_readers_on_phi3_table():
    cell = "phi3-mini-3.8b"
    r = _readings(cell, _trace(cell))
    gemm = r.cell.readers["gemm_ms.prefill"](r)
    assert gemm == pytest.approx(_per_call_ms(cell, lambda n: "nvjet" in n))
    assert 75 < gemm < 77
    ew = r.cell.readers["elementwise_ms.prefill"](r)
    assert ew == pytest.approx(_per_call_ms(
        cell, lambda n: "at::native" in n or "elementwise_kernel" in n))
    flash_ms = _per_call_ms(cell, lambda n: "flash_fwd" in n)
    bound = 32 * roofline.flash_bound_s(2, 4096, 32, 32, 96)[0]
    share = r.cell.readers["flash_roofline.prefill"](r)
    assert share == pytest.approx(100 * bound / (flash_ms / 1e3))
    assert 0 < share < 100
    idle = r.cell.readers["device_idle_share.prefill"](r)
    assert idle == pytest.approx(100 * 4 * 1e-4 / r.trace.window_s)


def test_activities_outside_the_window_are_left_out():
    """The lead call's activities, before the window, count nowhere."""
    cell = "phi3-mini-3.8b"
    full = _readings(cell, _trace(cell))
    t = _trace(cell)
    t.device[:0] = [("void tc::flash_fwd_tc_kernel<96>", -2e-3, -1e-3),
                    ("nvjet_tst_256x128", -1e-3, -5e-4)]
    led = _readings(cell, t)
    for m in ("flash_roofline.prefill", "gemm_ms.prefill",
              "device_idle_share.prefill"):
        assert led.cell.readers[m](led) == \
            pytest.approx(full.cell.readers[m](full))


def test_profile_calls_leaves_the_lead_call_out():
    calls = []

    def call(tokens):
        calls.append(tuple(tokens.shape))
        return tokens.float().sum(-1, keepdim=True)
    tokens = [torch.ones(2, 4, dtype=torch.long),
              torch.ones(1, 8, dtype=torch.long)]
    t = profile_calls(call, tokens)
    assert calls == [(1, 8), (2, 4), (1, 8)] and t.calls == 2
    names = [h[0] for h in t.host]
    assert names.count("portbench.call") == 2
    assert names.count("portbench.readback") == 2
    assert min(h[1] for h in t.host) >= t.t0


def test_ssd_reader_on_mamba2_table():
    cell = "mamba2-2.7b"
    r = _readings(cell, _trace(cell))
    ssd_ms = _per_call_ms(cell, lambda n: "tc::ssd_" in n)
    bound = 64 * roofline.ssd_bound_s(4, 2048, 80, 64, 1, 128, 128)[0]
    share = r.cell.readers["ssd_roofline.prefill"](r)
    assert share == pytest.approx(100 * bound / (ssd_ms / 1e3))
    assert 10 < share < 20
    assert r.cell.readers["gemm_ms.prefill"](r) == pytest.approx(
        _per_call_ms(cell, lambda n: "nvjet" in n))


def test_breakdown_names_gaps_by_the_host():
    cell = "mamba2-2.7b"
    b = _trace(cell).breakdown()
    assert len(b["device_ops"]) == 10 and len(b["idle_gaps"]) <= 10
    assert b["device_ops"][0][1] >= b["device_ops"][-1][1]
    assert b["idle_gaps"][0][0] == "portbench.readback"
    assert b["idle_gaps"][0][1] == pytest.approx(4 * 1e-4, rel=1e-6)


def test_readers_without_a_trace_are_silent():
    r = _readings("mamba2-2.7b", None,
                  latency_s=[0.3, 0.31, 0.29], enqueue_s=[0.2, 0.21, 0.19],
                  seconds=0.9)
    for m in ("gemm_ms.prefill", "ssd_roofline.prefill",
              "device_idle_share.prefill"):
        assert r.cell.readers[m](r) is None
    # a trace that holds no flash kernel, a model with no scan: silent
    r2 = _readings("phi3-mini-3.8b", _trace("mamba2-2.7b"))
    assert r2.cell.readers["flash_roofline.prefill"](r2) is None
    r2.cell.readers["ssd_roofline.prefill"] = harness.load_module(
        ROOT / "portbench" / "metrics" / "ssd_roofline.prefill.py").read
    assert r2.cell.readers["ssd_roofline.prefill"](r2) is None


def test_window_readers():
    lat = [0.16 + 0.001 * i for i in range(20)]
    r = _readings("phi3-mini-3.8b", None, latency_s=lat,
                  enqueue_s=[0.08] * 20, seconds=sum(lat),
                  shapes=[(2, 4096)] * 19 + [(4, 1920)],
                  counters={"flash_attention.flash_wgmma": 640})
    rd = r.cell.readers
    assert rd["prefill_tokens_per_s"](r) == pytest.approx(
        (19 * 8192 + 7680) / sum(lat))
    assert rd["prefill_p90_ms"](r) == pytest.approx(
        statistics.quantiles(lat, n=10, method="inclusive")[8] * 1e3)
    assert 0.176 * 1e3 < rd["prefill_p90_ms"](r) < 0.178 * 1e3
    assert rd["host_enqueue_ms.prefill"](r) == pytest.approx(80.0)
    assert rd["flash_launches.prefill"](r) == 32
    assert rd["setup_s"](r) == 12.5
    mfu = rd["mfu.prefill"](r)
    flops = 19 * 65_972_702_281_728 + DENSE.work(r.cell.model, 4, 1920)[
        "flops"]
    assert mfu == pytest.approx(100 * flops / sum(lat) / 989e12)
    assert 0 < mfu < 100
