"""The profiled stretch of a `--trace 1` run and what the metric readers
take from it.

`profile_calls` runs one cycle of the mix's calls under `torch.profiler`
(CUPTI on the card), each inside the ranges "portbench.call" (submission to
`forward` returning) and "portbench.readback" (the logits to the host), and
keeps every device activity (kernels, copies, sets) with its interval.

The profiler drops some of the first activities it sees (a first call's
first three launches).  So one lead call runs under it first and is left
out: the traced window starts at the next call's submission, and a
kernel's time a call is its recorded time in the window over the calls.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

#: idle gaps shorter than this are launch latency, not host work
GAP_MIN_S = 20e-6
NAME_CHARS = 160
#: the prefix of the harness's own ranges; the profiler also records them on
#: the device's timeline, where they are not device work
RANGE = "portbench."


@dataclass
class Trace:
    """Device activities [(name, start s, end s)] of `calls` calls, the
    host's ranges and operators [(name, start s, end s)] on the calling
    thread, and the traced window [t0, t1] (first submission to the last
    logits on the host), all on the profiler's clock."""
    calls: int
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    t0: float
    t1: float
    read_s: float = 0.0           # host seconds to read the profile

    def __post_init__(self):
        self.device.sort(key=lambda e: e[1])

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device activities, clipped to the window."""
        out: List[List[float]] = []
        for _, s, e in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def per_call_s(self, match: Callable[[str], bool]) -> Optional[float]:
        """Device seconds a call of the activities in the window whose names
        `match`; None when the window holds none."""
        hits = [min(e, self.t1) - max(s, self.t0)
                for name, s, e in self.device
                if match(name) and e > self.t0 and s < self.t1]
        return sum(hits) / self.calls if hits else None

    def gaps(self) -> List[Tuple[float, float]]:
        out, t = [], self.t0
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def host_at(self, t: float) -> str:
        """The outermost and innermost host ranges open at `t`, as
        "outer/inner"."""
        open_ = [h for h in self.host if h[1] <= t < h[2]]
        if not open_:
            return "host outside any range"
        open_.sort(key=lambda h: (h[1], -h[2]))
        outer, inner = open_[0][0], open_[-1][0]
        return outer if outer == inner else f"{outer}/{inner}"

    def breakdown(self) -> dict:
        """The ten device activities that took most time in the traced
        window, and the ten kinds of idle gap that did, named by what the
        host was doing (gaps under `GAP_MIN_S` summed as one)."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            by_name[name[:NAME_CHARS]] += e - s
        idle: Dict[str, float] = defaultdict(float)
        for s, e in self.gaps():
            key = self.host_at((s + e) / 2) if e - s >= GAP_MIN_S \
                else "gaps under 20 us"
            idle[key[:NAME_CHARS]] += e - s

        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_name), "idle_gaps": top(idle)}


def profile_calls(call, tokens) -> Trace:
    """Run the calls of the closed loop on `tokens` (a list of prompts)
    under the profiler, after a lead call on the last of them that the
    trace leaves out -> their `Trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for tok in tokens[-1:] + list(tokens):
            with record_function("portbench.call"):
                out = call(tok)
            with record_function("portbench.readback"):
                out.to("cpu")
        if cuda:
            torch.cuda.synchronize()
    t_read = time.perf_counter()
    events = prof.events()
    dev_type = torch.autograd.DeviceType.CUDA
    device, host = [], []
    thread = None
    for e in events:
        if e.device_type == dev_type:
            if not e.name.startswith(RANGE):
                device.append((e.name, e.time_range.start / 1e6,
                               e.time_range.end / 1e6))
        elif e.name == "portbench.call" and thread is None:
            thread = e.thread
    for e in events:
        if e.device_type != dev_type and e.thread == thread:
            host.append((e.name, e.time_range.start / 1e6,
                         e.time_range.end / 1e6))
    calls = sorted(h[1] for h in host if h[0] == "portbench.call")
    t0 = calls[1]                         # the lead call is left out
    t1 = max(h[2] for h in host if h[0] == "portbench.readback")
    trace = Trace(calls=len(tokens),
                  device=[d for d in device if d[2] > t0],
                  host=[h for h in host if h[2] > t0], t0=t0, t1=t1)
    trace.read_s = time.perf_counter() - t_read
    return trace
