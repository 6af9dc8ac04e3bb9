#!/usr/bin/env python3
"""Time the RMS-norm kernel (`kernels/rms_norm`) beside its plain version
(`ref.rms_norm`, the eager float32 chain) and its byte bound, on one CUDA
card, at the residual stream of the benchmark's three cells, bf16, x
contiguous [B, S, d], at each call shape of the cell's cycle: the widths,
the norms a call (`chip_smoke.norm_launches`: 65, 65 and 81) and the
cycles (`portbench.harness.schedule` of the cell's traffic) as the
benchmark's files give them:

  * CUDA events around one call enqueued behind a spin kernel, with a cold
    L2 (a 256 MB buffer read before each call) and a warm one, median of
    `chip_smoke.N_TIMED` (`chip_smoke.device_times_ms`);
  * torch.profiler's device time of the kernel a launch at each model's
    largest shape of the cycle;
  * the bound: x read and the output written once, the weight read once,
    at 3.35 TB/s (`chip_smoke.norm_bound_ms`), and the kernel's share of
    it;
  * per model call of the cycle (the calls' mean, every norm): the
    kernel's, the plain version's and the bound's summed cold times.

    python3 scripts/rms_norm_timing.py [--out FILE]

It prints one JSON line (and writes it to `--out` when given), beside the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("phi3-mini-3.8b.conv-2k", "mamba2-2.7b.code-4k",
         "granite-4.0-h-small.code-4k")
EPS = 1e-5


def cells():
    """-> {model: (d_model, norms a call, {(B, S): calls of a cycle},
    calls a cycle)} of `CELLS`, from the benchmark's files."""
    from chip_smoke import norm_launches
    from portbench.harness import load_cell, schedule
    from repro_torch.configs.base import ModelConfig
    out = {}
    for name in CELLS:
        cell = load_cell(ROOT, name)
        mc = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in cell.model.items()})
        cycle = schedule(cell.traffic)
        out[mc.name] = (mc.d_model, norm_launches(mc),
                        collections.Counter(cycle), len(cycle))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rms_norm_timing: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import device_busy, device_times_ms, norm_bound_ms
    from repro_torch.kernels.rms_norm import kernel, ops, ref
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rows, per_call = [], {}
    g = torch.Generator(dev).manual_seed(0)
    with torch.no_grad():
        for model, (d, norms, cycle, calls) in cells().items():
            total = per_call[model] = {"kernel_ms": 0.0, "plain_ms": 0.0,
                                       "bound_ms": 0.0}
            largest = max(b * s for b, s in cycle)
            for (b, s), n in sorted(cycle.items()):
                x = torch.randn(b, s, d, generator=g, device=dev).to(
                    torch.bfloat16)
                w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(
                    torch.bfloat16)
                run = lambda: ops.rms_norm(x, w, EPS)  # noqa: E731
                plain = lambda: ref.rms_norm(x, w, EPS)  # noqa: E731
                got, want = run().float(), plain().float()
                ms = device_times_ms(run, cold=True)
                plain_ms = device_times_ms(plain, cold=True)
                bound = norm_bound_ms(b * s, d)
                row = dict(model=model, shape=[b, s, d], kernel_ms=ms,
                           kernel_warm_ms=device_times_ms(run),
                           plain_ms=plain_ms, bound_ms=bound,
                           share_of_bound=bound / ms,
                           max_abs_vs_chain=float((got - want).abs().max()),
                           equal_share=float((got == want).float().mean()),
                           vector=kernel.vector_ok(x, w))
                if b * s == largest:
                    before = kernel.LAUNCHES["fused"]
                    busy = device_busy(lambda: [run() for _ in range(10)])[4]
                    fused = [(t, c) for name, (t, c) in busy.items()
                             if "rms_norm_kernel" in name]
                    row["profiler_ms"] = (sum(t for t, _ in fused) * 1e3
                                          / max(1, sum(c for _, c in fused))
                                          if fused else None)
                    row["profiled_launches"] = \
                        kernel.LAUNCHES["fused"] - before
                rows.append(row)
                for key in total:
                    total[key] += row[key] * n * norms / calls
                del x, w, got, want
                torch.cuda.empty_cache()
    out = {"card": smi, "torch": torch.__version__,
           "per_call_of_cycle": per_call, "shapes": rows}
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
