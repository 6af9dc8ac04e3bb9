#!/usr/bin/env python3
"""Time the two design-space-exploration paths of the `repro_torch` found
under `--src` on one CUDA card, with each scoring engine ("cuda": the
mapspace kernels, "torch": the plain oracle) in turns (cuda, torch, cuda,
...), traced, as `chip_smoke.py` runs them:

  * `fused_best` over the quickstart's 8 architectures x the 24 distinct
    workloads of AlexNet-CIFAR training at batch 64, no-bypass mapspaces
    of `MapperConfig(max_mappings=20000, seed=0)` (built once, not timed);
  * `explore` (paper Algorithm 1) of the same task over the same
    architectures, mapspaces built inside (timed).

For each path and engine it prints the median host-clock wall, every
run's wall and the span times of the median run; it checks that both
engines pick the same winners.

    python3 scripts/dse_timing.py [--src DIR] [--label NAME] [--runs N]
                                  [--explore-runs N] [--device cpu]

It prints one JSON line.  Run it for two checkouts in one call, in turns
(A, B, B, A), to compare them on one card; the timing helpers are this
checkout's `chip_smoke.py`.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _summary(res) -> dict:
    return {engine: {"median_s": r[0], "walls_s": r[1], "spans_s": r[2],
                     "launches": r[4]}
            for engine, r in res.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--runs", type=int, default=3,
                    help="runs of each engine on fused_best")
    ap.add_argument("--explore-runs", type=int, default=1,
                    help="runs of each engine on explore (0: skip it)")
    ap.add_argument("--device", default="cuda",
                    help="cpu runs the plain versions (a rehearsal)")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dse_timing: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                    # timing helpers only
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch
    from repro_torch.core import (MapperConfig, alexnet_cifar, analyze,
                                  build_packed_mapspace, explore,
                                  generate_arch_space)
    from repro_torch.core.explorer import _workload_key
    from repro_torch.search import MapspaceJob, fused_best

    dev = torch.device(args.device)
    task = analyze(alexnet_cifar(batch_size=cs.TASK_BATCH))
    distinct = list({_workload_key(w): w for w in task.intra}.values())
    archs = list(generate_arch_space(**cs.ARCH_SPACE))
    cfg = MapperConfig(max_mappings=cs.MAX_MAPPINGS, seed=0,
                       enable_bypass=False)
    t0 = time.perf_counter()
    jobs = [MapspaceJob(tag=(hw.name, wl.name), hw=hw, workload=wl,
                        packed=build_packed_mapspace(wl, hw, cfg))
            for hw in archs for wl in distinct]
    build_s = time.perf_counter() - t0
    fused = cs.engine_turns(lambda engine: fused_best(
        jobs, "edp", device=dev, backend=engine), n=args.runs)
    same = [(b.tag, b.index) for b in fused["cuda"][5]] == \
        [(b.tag, b.index) for b in fused["torch"][5]]
    out = {"label": args.label, "repro_torch": repro_torch.__file__,
           "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                      else "cpu"),
           "fused": {"jobs": len(jobs),
                     "rows": sum(j.n_rows() for j in jobs),
                     "build_s": build_s, **_summary(fused)},
           "winners_equal": same}
    if args.explore_runs:
        ex_cfg = MapperConfig(max_mappings=cs.MAX_MAPPINGS, seed=0)
        ex = cs.engine_turns(lambda engine: explore(
            task, archs, goal="edp", cfg=ex_cfg, backend=engine,
            device=dev), n=args.explore_runs)
        out["explore"] = _summary(ex)
        out["winners_equal"] = same and cs._winners(ex["cuda"][5]) == \
            cs._winners(ex["torch"][5])
    print(json.dumps(out), flush=True)
    return 0 if out["winners_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
