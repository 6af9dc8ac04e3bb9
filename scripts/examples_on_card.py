#!/usr/bin/env python3
"""Run the port's five examples (`examples/port/*.py`) on the card, each as
a subprocess at its defaults (`--device cuda`), and `dse_modern_lm` also
with `--strategy anneal --budget 8`:

    python3 scripts/examples_on_card.py [--out-dir chiprun_out/examples]

Each must exit 0, which includes passing its own assertion.  Prints the
card's name and power limit (nvidia-smi), then one line per run with its
wall (host clock, the interpreter's start included) and its last lines;
each run's whole output goes to `<out-dir>/<run>.log`.  Exits non-zero
if there is no card or any run fails.
"""
import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# (label, example, arguments besides --device cuda)
RUNS = [("quickstart", "quickstart", []),
        ("explore_training_asic", "explore_training_asic", []),
        ("dse_modern_lm", "dse_modern_lm", []),
        ("dse_modern_lm_anneal", "dse_modern_lm",
         ["--strategy", "anneal", "--budget", "8"]),
        ("serve_lm", "serve_lm", []), ("train_lm", "train_lm", [])]
TAIL = 6
RUN_TIMEOUT_S = 900


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=str(ROOT / "chiprun_out" /
                                             "examples"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("examples_on_card: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    failed, t_all = [], time.perf_counter()
    for name, example, extra in RUNS:
        script = ROOT / "examples" / "port" / f"{example}.py"
        cmd = [sys.executable, str(script), "--device", "cuda", *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=RUN_TIMEOUT_S, cwd=ROOT,
                              env={**os.environ, "PYTHONUNBUFFERED": "1"})
        wall = time.perf_counter() - t0
        (out_dir / f"{name}.log").write_text(proc.stdout + proc.stderr)
        tail = (proc.stdout + proc.stderr).strip().splitlines()[-TAIL:]
        status = "ok" if proc.returncode == 0 else \
            f"FAILED (exit {proc.returncode})"
        print(f"[{name}] {' '.join(cmd[1:])}: {status}, {wall:.1f} s "
              f"wall", flush=True)
        for line in tail:
            print(f"    {line}", flush=True)
        if proc.returncode:
            failed.append(name)
    print(f"[examples] {len(RUNS) - len(failed)} of {len(RUNS)} runs "
          f"exited 0 in {time.perf_counter() - t_all:.1f} s on {smi}"
          + (f"; failed: {failed}" if failed else ""), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
