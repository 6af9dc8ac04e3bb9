#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 and the CUDA toolkit's
`nvcc`.  It imports nothing of JAX and nothing of the JAX package `repro`.
Each phase prints one line; any failure exits non-zero, and no phase
catches its own failure.

  1. device   the card's name and power limit (nvidia-smi) and capability
  2. build    nvcc builds the mapspace-scoring kernels from this checkout
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shapes (AlexNet-CIFAR `intra[2]`, no-bypass
              mapspace) and on a ragged 37-row slice; times from CUDA events
              (median of 25 calls, with a cold L2 and a warm one) and from
              torch.profiler (CUPTI), beside the bytes bound
  4. explore  paper Algorithm 1 at full width: AlexNet-CIFAR training at
              batch 64 (29 workloads) over the 8-architecture quickstart
              space, `MapperConfig(max_mappings=20000, seed=0)`; the
              single-architecture kernel must launch, and the winners must
              equal those of the plain oracle (`backend="torch"`); a
              profiled run over two architectures gives the device's busy
              share
  5. fused    `fused_best` over the 8 architectures x 24 distinct
              workloads, no-bypass mapspaces, traced (pack, copies,
              kernel, validity); the multi-architecture kernel must
              launch, and the winners must equal the oracle's

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SECTOR_BYTES = 32            # the smallest read the memory system serves
# Float operations the kernel does per mapping row for S = 21 slots and 3
# chain pairs, as the note at the top of the .cu file counts them: about
# 245 arithmetic (at most 42 of them the psum products) and 84 compares.
# The bound is set by bytes by more than an order of magnitude, so the
# count only has to be of the right size.
FLOPS_PER_ROW = 330
CYC_RTOL, EN_RTOL = 1e-5, 1e-4
N_TIMED = 25
L2_FLUSH_BYTES = 256 << 20   # > 5x the H100's 50 MB L2

TASK_BATCH = 64
ARCH_SPACE = dict(num_pes=(64, 256), rf_words=(128, 256),
                  gbuf_words=(32 * 1024, 128 * 1024), bits=32,
                  zero_skip=True)
CHECK_ARCH = "pe256_rf256_gb131072"     # the issue's intra[2] architecture
MAX_MAPPINGS = 20000
SOURCE = "src/repro_torch/kernels/mapspace_eval/csrc/mapspace_eval.cu"


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def device_phase() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    say("device", f"{torch.cuda.get_device_name(0)} capability {cap} "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability (9, 0), got {cap}")
    return smi


def build_phase() -> None:
    from repro_torch.kernels.mapspace_eval import kernel
    t0 = time.perf_counter()
    lib = kernel.build()
    dt = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    say("build", f"{lib.relative_to(ROOT)} in {dt:.2f} s; "
        + " | ".join(ptxas))


def device_times_ms(fn, n: int = N_TIMED, cold: bool = False):
    """Median device time of one `fn()` call over `n` calls, from a CUDA
    event pair around each.  Each call is enqueued while the card spins in
    `torch.cuda._sleep`, so its launches run back to back and the events
    time the device, not the host's launch rate (one call at a time: the
    plain version's ~370 launches a call nearly fill the launch queue).
    `cold`: before each call a 256 MB buffer is read, so the inputs come
    from HBM and not from the L2 where the previous call left them."""
    flush = (torch.zeros(L2_FLUSH_BYTES // 4, device="cuda") if cold
             else None)
    for _ in range(3):                                  # warm-up
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin = int(2e9 * 2 * (time.perf_counter() - t0)) + 1000  # <= 2 GHz
    times = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        if flush is not None:
            flush.sum()
        torch.cuda._sleep(spin)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_busy(fn):
    """Run `fn()` under torch.profiler (CUPTI) -> (wall s, device busy s,
    device activities, their summed s): busy is the union of the kernel
    and copy intervals, so overlapping work is not counted twice."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:                                  # microseconds
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return wall, busy / 1e6, len(spans), sum(e - s for s, e in spans) / 1e6


def bound_ms(tensors, n_rows: int):
    """The least time the card could take: the bytes the function needs
    at HBM bandwidth, or its float operations at the float32 peak,
    whichever is larger.  Every input but `fresh` is read once in full and
    both outputs are written once.  Of `fresh` [B, L1, S] the function
    needs one float per (row, level) whose input has an active relevant
    loop, as this run's data says; each is a 32-byte sector of its own,
    since rows lie 4 * L1 * S bytes apart."""
    bounds, rel_i, fresh = tensors[0], tensors[2], tensors[7]
    act = (rel_i > 0) & (bounds > 1)
    n_fresh = sum(int(act[:, :7 * (j + 1)].any(1).sum())
                  for j in range(fresh.shape[1]))
    nbytes = (sum(t.numel() * t.element_size() for t in tensors)
              - fresh.numel() * fresh.element_size()
              + SECTOR_BYTES * n_fresh + 8 * n_rows)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_ROW * n_rows / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, out, ref):
    """Kernel (cycles, energy) against the plain version -> max abs err."""
    (c, e), (cr, er) = out, ref
    torch.cuda.synchronize()
    if not (torch.isfinite(c).all() and torch.isfinite(e).all()):
        raise RuntimeError(f"{name}: non-finite kernel output")
    torch.testing.assert_close(c, cr, rtol=CYC_RTOL, atol=0)
    torch.testing.assert_close(e, er, rtol=EN_RTOL, atol=0)
    rel = max(float(((c - cr).abs() / cr.abs()).max()),
              float(((e - er).abs() / er.abs()).max()))
    return max(float((c - cr).abs().max()), float((e - er).abs().max())), rel


def kernel_phase(archs, workload, dev):
    """Both kernels against `ref.py` on the card -> per-kernel records."""
    from repro_torch.core import MapperConfig, build_packed_mapspace
    from repro_torch.kernels.mapspace_eval import kernel, ops, ref
    cfg = MapperConfig(max_mappings=MAX_MAPPINGS, seed=0,
                       enable_bypass=False)
    packed = {hw.name: build_packed_mapspace(workload, hw, cfg)
              for hw in archs}
    pm = packed[CHECK_ARCH]
    arrays, static, n = ops.pack_for_kernel_arrays(pm.static, pm.factors,
                                                   pm.rank)
    single = [torch.from_numpy(a).to(dev) for a in arrays]
    fused, n_multi = ops.pack_for_kernel_multi(
        [(p.static, p.factors, p.rank) for p in packed.values()])
    multi = [torch.from_numpy(a).to(dev) for a in fused]
    cases = [
        ("mapspace_eval_single", "src/repro/kernels/mapspace_eval/"
         "kernel.py:133", single, n,
         lambda t: kernel.mapspace_eval_fwd(*t, static=static),
         lambda t: ref.score_ref(*t, static=static)),
        ("mapspace_eval_multi", "src/repro/kernels/mapspace_eval/"
         "kernel.py:163", multi, n_multi,
         lambda t: kernel.mapspace_eval_multi_fwd(*t),
         lambda t: ref.score_multi_ref(*t)),
    ]
    records = {}
    for name, replaces, tensors, rows, run, plain in cases:
        err, rel = compare(name, run(tensors), plain(tensors))
        ragged = [t[:37].contiguous() for t in tensors]
        compare(name + "[:37]", run(ragged), plain(ragged))
        ms = device_times_ms(lambda: run(tensors), cold=True)
        warm_ms = device_times_ms(lambda: run(tensors))
        plain_ms = device_times_ms(lambda: plain(tensors), cold=True)
        plain_warm_ms = device_times_ms(lambda: plain(tensors))
        b_ms, b_by = bound_ms(tensors, rows)
        cupti = [device_busy(lambda: [f(tensors) for _ in range(N_TIMED)])
                 for f in (run, plain)]
        say("kernels", f"{name}: {rows} rows, max abs err {err:.3g} "
            f"(max rel {rel:.3g}; 37-row slice ok); events, cold L2: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; warm L2: kernel "
            f"{warm_ms:.4f} ms, plain {plain_warm_ms:.4f} ms; bound "
            f"{b_ms:.5f} ms ({b_by}); profiler, warm, device activity per "
            f"call: kernel {cupti[0][3] / N_TIMED * 1e3:.4f} ms in "
            f"{cupti[0][2] / N_TIMED:.0f} op(s), plain "
            f"{cupti[1][3] / N_TIMED * 1e3:.4f} ms in "
            f"{cupti[1][2] / N_TIMED:.0f} ops")
        records[name] = dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            warm_ms=warm_ms, plain_warm_ms=plain_warm_ms)
    say("kernels", f"intra[2] mapspaces, no bypass: "
        + ", ".join(f"{k} {len(p)}" for k, p in packed.items()))
    return records


def _winners(result):
    return [(a.hardware.name,
             [(w.mapping.factors, w.mapping.orders, w.mapping.bypass)
              for w in a.per_workload]) for a in result.all_archs]


def explore_phase(task, archs, dev):
    """Algorithm 1 on the card, kernel engine then oracle -> launches."""
    from repro_torch.core import MapperConfig, explore
    from repro_torch.kernels.mapspace_eval import kernel
    from repro_torch.obs import Tracer, activate
    cfg = MapperConfig(max_mappings=MAX_MAPPINGS, seed=0)
    tr = Tracer()
    kernel.reset_launches()
    t0 = time.perf_counter()
    with activate(tr):
        out = explore(task, archs, goal="edp", cfg=cfg, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(kernel.LAUNCHES)
    if launches["single"] == 0:
        raise RuntimeError("explore launched no single-architecture kernel")
    sp = tr.span_times()
    m = tr.metrics.snapshot()["counters"]
    split = {k: sp.get(v, 0.0) for k, v in (
        ("mapspace build", "pack"), ("mapspace validate", "validate"),
        ("kernel pack (host)", "kernel.pack"), ("copy to device",
                                                "kernel.h2d"),
        ("kernel", "kernel.run"), ("copy back", "kernel.d2h"),
        ("validity (host)", "backend.validity"),
        ("oracle (bypass rows, incl. copies)", "batch_eval.scores"))}
    say("explore", f"backend=cuda {wall:.2f} s wall, launches {launches}, "
        f"rows kernel {m.get('backend.rows.kernel', 0):.0f} / oracle "
        f"{m.get('backend.rows.torch', 0):.0f}; split: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in split.items()))
    t0 = time.perf_counter()
    ref = explore(task, archs, goal="edp", cfg=cfg, backend="torch",
                  device=dev)
    say("explore", f"backend=torch {time.perf_counter() - t0:.2f} s wall")
    for a in out.all_archs:
        n = a.network
        if not all(map(lambda v: v > 0 and v < float("inf"),
                       (n.cycles, n.energy_pj, n.edp))):
            raise RuntimeError(f"{a.hardware.name}: bad network estimate")
    if out.best.hardware.name != ref.best.hardware.name \
            or _winners(out) != _winners(ref):
        raise RuntimeError("explore winners differ between the kernel "
                           "engine and the oracle")
    wall, busy, n_ops, _ = device_busy(lambda: explore(
        task, archs[:2], goal="edp", cfg=cfg, device=dev))
    say("explore", f"profiled run over {archs[0].name}, {archs[1].name}: "
        f"{wall:.2f} s wall, device busy {busy:.3f} s "
        f"({100 * busy / wall:.2f}%, idle {100 - 100 * busy / wall:.2f}%) "
        f"in {n_ops} device ops")
    say("explore", f"best {out.best.hardware.name} edp "
        f"{out.best.network.edp:.6g} cycles {out.best.network.cycles:.6g}; "
        f"{len(out.all_archs)} archs x {len(out.best.per_workload)} "
        f"workloads: winners equal the oracle's")
    return launches["single"]


def fused_phase(workloads, archs, dev):
    """`fused_best` over every (arch, distinct workload) pair -> launches."""
    from repro_torch.core import MapperConfig, build_packed_mapspace
    from repro_torch.kernels.mapspace_eval import kernel
    from repro_torch.obs import Tracer, activate
    from repro_torch.search import MapspaceJob, fused_best
    cfg = MapperConfig(max_mappings=MAX_MAPPINGS, seed=0,
                       enable_bypass=False)
    t0 = time.perf_counter()
    jobs = [MapspaceJob(tag=(hw.name, wl.name), hw=hw, workload=wl,
                        packed=build_packed_mapspace(wl, hw, cfg))
            for hw in archs for wl in workloads]
    build_s = time.perf_counter() - t0
    rows = sum(j.n_rows() for j in jobs)
    tr = Tracer()
    kernel.reset_launches()
    t0 = time.perf_counter()
    with activate(tr):
        out = fused_best(jobs, "edp", device=dev)
    wall = time.perf_counter() - t0
    launches = dict(kernel.LAUNCHES)
    if launches["multi"] == 0:
        raise RuntimeError("fused_best launched no multi-architecture "
                           "kernel")
    sp = tr.span_times()
    split = {k: sp.get(v, 0.0) for k, v in (
        ("kernel pack (host)", "kernel.pack"), ("copy to device",
                                                "kernel.h2d"),
        ("kernel", "kernel.run"), ("copy back", "kernel.d2h"),
        ("validity (host)", "fused.validity"))}
    split["rest (grouping, scores, argmin)"] = wall - sum(split.values())
    say("fused", f"backend=cuda {wall:.3f} s wall, split: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()))
    t0 = time.perf_counter()
    ref = fused_best(jobs, "edp", device=dev, backend="torch")
    ref_s = time.perf_counter() - t0
    if [(b.tag, b.index) for b in out] != [(b.tag, b.index) for b in ref]:
        raise RuntimeError("fused_best winners differ between the kernel "
                           "and the oracle")
    say("fused", f"{len(jobs)} jobs, {rows} rows (built in {build_s:.2f} s); "
        f"backend=cuda {wall:.3f} s, launches {launches}; backend=torch "
        f"{ref_s:.3f} s; winners equal the oracle's")
    return launches["multi"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core import alexnet_cifar, analyze, generate_arch_space
    from repro_torch.core.explorer import _workload_key
    t_start = time.perf_counter()
    device_phase()
    device_busy(lambda: torch.ones(1, device="cuda").sum())  # CUPTI warm-up
    build_phase()
    dev = torch.device("cuda", 0)
    task = analyze(alexnet_cifar(batch_size=TASK_BATCH))
    distinct = list({_workload_key(w): w for w in task.intra}.values())
    archs = list(generate_arch_space(**ARCH_SPACE))
    say("setup", f"AlexNet-CIFAR batch {TASK_BATCH}: {len(task.intra)} "
        f"intra workloads, {len(distinct)} distinct; {len(archs)} archs")
    records = kernel_phase(archs, task.intra[2], dev)
    records["mapspace_eval_single"]["launches"] = explore_phase(
        task, archs, dev)
    records["mapspace_eval_multi"]["launches"] = fused_phase(
        distinct, archs, dev)
    say("done", f"{time.perf_counter() - t_start:.1f} s total")
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
