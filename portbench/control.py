#!/usr/bin/env python3
"""Readings for a cell's limits: the numbers the check compares, for the
program on many seeds (the lower readings) and for the control on some
(the upper readings), in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 5]

For each seed it makes the weights and prompts as a run does, drives the
timed path in the closed loop for `--seconds`, and compares the run's
sample of calls with the float32 reference (`harness.check`'s numbers).
On the control seeds it also computes the control: the reference put in
the program's place with every weight product in float8 e4m3, the step
below the configuration's bf16 (`reference.plain.Products("fp8")`), on the
same prompts, held to the same reference.  The benchmark's runs never run
the control.  One JSON line a seed, then a summary line: the largest
program reading and the smallest control reading of each number.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, seconds: float, device, control: bool) -> dict:
    """The program's compared numbers on `seed` (and the control's)."""
    import torch
    from portbench import harness as h
    weights, call, prompt = h.set_up(cell, seed, device)
    window = h.closed_loop(call, prompt, seconds)
    prog, ctrl = {}, {}
    for i in h.check_sample(seed, window.shapes):
        tokens = prompt(i).to(device)
        ref = h.reference_logits(cell, weights, tokens)
        prog = h.worst(prog, h.compare(window.outputs[i], ref))
        if control:
            low = h.reference_logits(cell, weights, tokens, "fp8")
            ctrl = h.worst(ctrl, h.compare(low, ref))
    del call, weights
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "calls": window.calls, "program": prog}
    if control:
        out["control"] = ctrl
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench import harness
    from portbench.run import require_cards
    cell = harness.load_cell(ROOT, args.workload)
    require_cards(cell.chips)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in seeds + sorted(ctrl_seeds - set(seeds)):
        rows.append(readings(cell, seed, args.seconds, device,
                             seed in ctrl_seeds))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": cell.name,
               "device": torch.cuda.get_device_name(device),
               "program_max": {}, "control_min": {}}
    for r in rows:
        for k, v in r["program"].items():
            summary["program_max"][k] = max(summary["program_max"]
                                            .get(k, v), v)
        for k, v in r.get("control", {}).items():
            summary["control_min"][k] = min(summary["control_min"]
                                            .get(k, v), v)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
