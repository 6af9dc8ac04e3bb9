#!/usr/bin/env python3
"""Device time by the program's spans: a profiled cycle of a cell's mix
with a recording `repro_torch.obs.Tracer` active, each device activity put
down to the innermost program span open on the calling thread when the
host launched it.

    python3 portbench/spans.py --workload <cell> --seed <n>

The program opens its spans (`obs.MODEL_SPANS`) as `torch.profiler`
ranges while the profiler records.  A kernel's correlation id gives its
launch call's event (CUDA runtime or `cu*` API), and its host time lies in
the spans open then; the `ctypes` launches of the flash and SSD kernels,
which no ATen operator encloses, are found the same way (`attribute`).

After the weights, the warm-up and a closed loop of `WARM_S` seconds as a
run makes them, it profiles the cycle of the mix that a `--trace 1` run
profiles (the "traced" prompts, after a lead call left out), in turns with
the tracer held off and on ("off", "on", "on", "off"), and prints one
JSON line a stretch, then a summary: device ms a call by innermost span,
the share of the device time launched inside "portbench.call" that a span
owns, the flash and SSD kernels' time under "attn.core" and "ssm.scan"
against their time by name, the trace's per-layer metrics as the cell's
readers read them, the host's enqueue and the device's idle share, and
the idle gaps named by the span and operator the host was in.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import time
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]
#: the host's launch calls: the CUDA runtime's ("cudaLaunchKernel",
#: "cudaMemcpyAsync") and the low-level API's ("cuLaunchKernelEx")
LAUNCH = re.compile(r"cu(da)?[A-Z]")
#: the harness's own ranges
HARNESS = ("portbench.call", "portbench.readback")
GAP_MIN_S = 20e-6
#: seconds of the closed loop before the profiled stretches
WARM_S = 5.0

Range = Tuple[str, float, float]


def innermost(ranges: Sequence[Range], times: Sequence[float]
              ) -> List[Optional[str]]:
    """The name of the innermost range of `ranges` (name, start, end),
    nested as one thread's are, open at each of `times` (start <= t <
    end), or None."""
    spans = sorted(ranges, key=lambda r: (r[1], -r[2]))
    order = sorted(range(len(times)), key=lambda i: times[i])
    out: List[Optional[str]] = [None] * len(times)
    stack: List[Range] = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][1] <= t:
            while stack and stack[-1][2] <= spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out[i] = stack[-1][0] if stack else None
    return out


def attribute(ranges: Sequence[Range], launches: Dict[int, float],
              activities: Sequence[Tuple[str, float, float, int]],
              is_span: Callable[[str], bool]) -> List[Optional[str]]:
    """The innermost program span at each device activity's launch.

    `ranges`: the calling thread's host ranges (name, start, end): the
    program's spans, the harness's ranges, ATen operators, of which
    `is_span(name)` tells the spans; `launches`: {correlation id: host
    time of the CUDA launch call}; `activities`: (name,
    start, end, correlation id) -> one span name, or None where the launch
    lies outside every span or was not recorded, an activity."""
    spans = [r for r in ranges if is_span(r[0])]
    at = [launches.get(a[3]) for a in activities]
    known = [i for i, t in enumerate(at) if t is not None]
    names = innermost(spans, [at[i] for i in known])
    out: List[Optional[str]] = [None] * len(activities)
    for i, name in zip(known, names):
        out[i] = name
    return out


@dataclass
class Stretch:
    """One profiled cycle: the `trace.Trace` the readers read (work
    activities only, in start order), the innermost span that launched
    each (`owners`, None outside every span), whether its launch lay in a
    "portbench.call" range (`in_call`), the thread's program spans and
    ATen operators, each call's host seconds to `forward`'s return, and
    the count of activities whose launch the profiler did not record."""
    trace: object
    owners: List[Optional[str]]
    in_call: List[bool]
    spans: List[Range]
    ops: List[Range]
    enqueue_s: List[float]
    unlaunched: int

    def clipped(self, i: int) -> float:
        _, s, e = self.trace.device[i]
        return max(0.0, min(e, self.trace.t1) - max(s, self.trace.t0))

    def ms_by_span(self) -> Dict[str, float]:
        """Device ms a call in the window by innermost span ("(none)"
        outside every span)."""
        out: Dict[str, float] = defaultdict(float)
        for i, owner in enumerate(self.owners):
            out[owner or "(none)"] += self.clipped(i) * 1e3 \
                / self.trace.calls
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def ms_of(self, match: Callable[[str], bool], span: Optional[str] = None
              ) -> float:
        """Device ms a call of the activities whose names `match` (and,
        given `span`, whose innermost span it is)."""
        return sum(self.clipped(i) for i, (name, _, _) in
                   enumerate(self.trace.device)
                   if match(name) and (span is None
                                       or self.owners[i] == span)) \
            * 1e3 / self.trace.calls

    def attributed_share(self) -> Optional[float]:
        """The share of the window's device time launched inside
        "portbench.call" that a program span owns."""
        tot = own = 0.0
        for i, owner in enumerate(self.owners):
            if self.in_call[i]:
                tot += self.clipped(i)
                own += self.clipped(i) if owner else 0.0
        return own / tot if tot else None

    def idle_gaps(self) -> Dict[str, float]:
        """Idle seconds of the window by what the host was in at the
        gap's middle: "outer/<innermost span>/<innermost op>" (gaps under
        `GAP_MIN_S` as one entry)."""
        t = self.trace
        mids = [(s + e) / 2 for s, e in t.gaps()]
        span_at = innermost(self.spans, mids)
        op_at = innermost(self.ops, mids)
        out: Dict[str, float] = defaultdict(float)
        for (s, e), sp, op in zip(t.gaps(), span_at, op_at):
            if e - s < GAP_MIN_S:
                key = "gaps under 20 us"
            else:
                outer = t.host_at((s + e) / 2).split("/")[0]
                key = "/".join(k for k in (outer, sp, op) if k)
            out[key] += e - s
        return dict(sorted(out.items(), key=lambda kv: -kv[1])[:12])


def profile_stretch(call, tokens, tracer) -> Stretch:
    """The calls on `tokens` under the profiler with `tracer` the ambient
    tracer, after a lead call on the last of them that the window leaves
    out (as `trace.profile_calls`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.trace import Trace
    from repro_torch.obs import activate
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    enqueue = []
    with profile(activities=acts) as prof, activate(tracer):
        for tok in tokens[-1:] + list(tokens):
            with record_function("portbench.call"):
                t = time.perf_counter()
                out = call(tok)
                enqueue.append(time.perf_counter() - t)
            with record_function("portbench.readback"):
                out.to("cpu")
        if cuda:
            torch.cuda.synchronize()
    # the ranges' names: the harness's and the spans the tracer opened
    # (the profiler also lays a range on the device's timeline, not work)
    program = {sp.name for sp in tracer.buffer.snapshot()} \
        if tracer.buffer is not None else set()
    ranges = program | set(HARNESS)
    events = prof.profiler.kineto_results.events()
    thread = next(e.start_thread_id() for e in events
                  if e.name() == "portbench.call")
    work, launches, host = [], {}, []
    for e in events:
        name = e.name()
        start = e.start_ns() / 1e9
        span = (name, start, start + e.duration_ns() / 1e9)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name not in ranges:
                work.append(span + (e.correlation_id(),))
        elif LAUNCH.match(name):
            launches[e.correlation_id()] = start
        if e.start_thread_id() == thread and \
                e.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(span)
    calls = sorted(h[1] for h in host if h[0] == "portbench.call")
    t0 = calls[1]
    t1 = max(h[2] for h in host if h[0] == "portbench.readback")
    work = sorted((w for w in work if w[2] > t0), key=lambda w: w[1])
    owners = attribute(host, launches, work, program.__contains__)
    in_call = [owner is not None for owner in attribute(
        host, launches, work, "portbench.call".__eq__)]
    trace = Trace(calls=len(tokens), device=[w[:3] for w in work],
                  host=[h for h in host if h[2] > t0], t0=t0, t1=t1)
    return Stretch(trace=trace, owners=owners, in_call=in_call,
                   spans=[h for h in host if h[0] in program],
                   ops=[h for h in host if h[0].startswith("aten::")],
                   enqueue_s=enqueue[1:],
                   unlaunched=sum(w[3] not in launches for w in work))


def report(cell, stretch: Stretch, mode: str, shapes) -> dict:
    """One stretch's line: the readers' per-layer metrics of the trace,
    the enqueue and, with spans on, device ms by span and the checks."""
    from portbench import harness
    readings = harness.Readings(cell, 0.0, harness.Window(), stretch.trace,
                                traced_shapes=shapes)
    out = {"mode": mode,
           "enqueue_ms": statistics.median(stretch.enqueue_s) * 1e3,
           "busy_s": stretch.trace.busy_s, "window_s": stretch.trace.window_s,
           "metrics": {k: v["value"] for k, v in harness.read_metrics(
               cell.per_layer, readings).items()},
           "unlaunched": stretch.unlaunched}
    if mode == "off":
        return out
    bench = ROOT / "portbench" / "metrics"
    flash = harness.load_module(bench / "flash_roofline.prefill.py").is_flash
    ssd = harness.load_module(bench / "ssd_roofline.prefill.py").is_ssd
    elem = harness.load_module(bench / "elementwise_ms.prefill.py") \
        .is_elementwise
    by_span = stretch.ms_by_span()
    out.update(
        ms_by_span=by_span, attributed_share=stretch.attributed_share(),
        flash_ms={"by_name": stretch.ms_of(flash),
                  "attn.core": stretch.ms_of(flash, "attn.core")},
        ssd_ms={"by_name": stretch.ms_of(ssd),
                "ssm.scan": stretch.ms_of(ssd, "ssm.scan")},
        elementwise_by_span={k: v for k, v in sorted(
            ((s, stretch.ms_of(elem, s)) for s in by_span
             if s != "(none)"), key=lambda kv: -kv[1]) if v},
        idle_gaps=stretch.idle_gaps(),
        spans_a_call=len(stretch.spans) / (stretch.trace.calls + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch
    from portbench import harness
    from portbench.run import require_cards
    from repro_torch.obs import NULL_TRACER, Tracer
    cell = harness.load_cell(ROOT, args.workload)
    require_cards(cell.chips)
    device = torch.device("cuda", 0)
    _, call, prompt = harness.set_up(cell, args.seed, device)
    harness.closed_loop(call, prompt, WARM_S)
    traced = harness.prompts(args.seed, cell.traffic,
                             cell.config["token_ids"], "traced")
    tokens = [traced(i) for i in range(len(harness.schedule(cell.traffic)))]
    shapes = [tuple(t.shape) for t in tokens]
    lines = []
    for mode in ("off", "on", "on", "off"):
        tracer = Tracer() if mode == "on" else NULL_TRACER
        lines.append(report(cell, profile_stretch(call, tokens, tracer),
                            mode, shapes))
        print(json.dumps(lines[-1]), flush=True)
    summary = {"workload": cell.name, "seed": args.seed,
               "device": torch.cuda.get_device_name(device)}
    for mode in ("off", "on"):
        rows = [ln for ln in lines if ln["mode"] == mode]
        summary[mode] = {
            "enqueue_ms": [ln["enqueue_ms"] for ln in rows],
            "idle_share": [ln["metrics"].get("device_idle_share.prefill")
                           for ln in rows]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    sys.exit(main())
