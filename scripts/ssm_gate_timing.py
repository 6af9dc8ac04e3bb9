#!/usr/bin/env python3
"""Time Mamba2's gate-chain kernel (`kernels/ssm_gate`) beside its plain
version (`ref.gate_chain`, the eager chain) and its byte bound, on one CUDA
card, at mamba2-2.7b's layer (80 heads of 64, d_inner 5120, 64 layers) and
granite-4.0-h-small's (128 heads of 64, d_inner 8192, 36 Mamba2 layers),
bf16, on the model's layout (y contiguous, xh the first d_inner columns of
the conv's float32 output, z the first d_inner columns of in_proj's), for
each call shape of the benchmark's `code-4k` cycle:

  * CUDA events around one call enqueued behind a spin kernel, with a cold
    L2 (a 256 MB buffer read before each call) and a warm one, median of
    `chip_smoke.N_TIMED` (`chip_smoke.device_times_ms`);
  * torch.profiler's device time of the kernel a launch at [4, 2048];
  * the bound: the bytes the chain must move (float32 y and xh and bf16 z
    read once, the bf16 output written once, D and out_norm once) at 3.35
    TB/s (`chip_smoke.gate_bound_ms`), and the kernel's share of it;
  * per model call of the cycle (the 8 calls' mean, every Mamba2 layer):
    the kernel's, the plain version's and the bound's summed cold times.

    python3 scripts/ssm_gate_timing.py [--out FILE]

It prints one JSON line (and writes it to `--out` when given), beside the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
#: the code-4k cycle's call shapes [B, S] and how often each comes
CYCLE = [((9, 896), 1), ((5, 1408), 1), ((4, 2048), 1), ((3, 2560), 1),
         ((2, 3328), 1), ((2, 4096), 3)]
P, GN, EPS = 64, 128, 1e-5
#: model -> (SSM heads, Mamba2 layers)
MODELS = {"mamba2-2.7b": (80, 64), "granite-4.0-h-small": (128, 36)}


def _inputs(b, t, h, dev, seed=0):
    """(y, xh, D, z, out_norm) on the model's layout, bf16 where the model
    keeps bf16."""
    g = torch.Generator(dev).manual_seed(seed)
    di = h * P

    def r(*s):
        return torch.randn(s, generator=g, device=dev)

    conv32 = r(b, t, di + 2 * GN)
    zxbcdt = r(b, t, 2 * di + 2 * GN + h).to(torch.bfloat16)
    return (r(b, t, h, P), conv32[..., :di].unflatten(-1, (h, P)),
            r(h).to(torch.bfloat16), zxbcdt[..., :di],
            (1 + 0.1 * r(di)).to(torch.bfloat16))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssm_gate_timing: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import device_busy, device_times_ms, gate_bound_ms
    from repro_torch.kernels.ssm_gate import kernel, ops, ref
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rows, per_call = [], {}
    bf16 = torch.bfloat16
    with torch.no_grad():
        for model, (h, layers) in MODELS.items():
            total = per_call[model] = {"kernel_ms": 0.0, "plain_ms": 0.0,
                                       "bound_ms": 0.0}
            for (b, t), n in CYCLE:
                a = _inputs(b, t, h, dev)
                run = lambda: ops.ssm_gate(*a, eps=EPS,  # noqa: E731
                                           dtype=bf16)
                plain = lambda: ref.gate_chain(*a, EPS, bf16)  # noqa: E731
                got, want = run().float(), plain().float()
                err = float((got - want).abs().max())
                ms = device_times_ms(run, cold=True)
                warm = device_times_ms(run)
                plain_ms = device_times_ms(plain, cold=True)
                bound = gate_bound_ms(b, t, h * P, h)
                row = dict(model=model, shape=[b, t], kernel_ms=ms,
                           kernel_warm_ms=warm, plain_ms=plain_ms,
                           bound_ms=bound, share_of_bound=bound / ms,
                           max_abs_vs_bf16_chain=err,
                           vector=kernel.vector_ok(*a[:2], a[3], a[4]))
                if (b, t) == (4, 2048):
                    before = kernel.LAUNCHES["fused"]
                    busy = device_busy(lambda: [run() for _ in range(10)])[4]
                    fused = [(s, c) for name, (s, c) in busy.items()
                             if "ssm_gate_kernel" in name]
                    row["profiler_ms"] = (sum(s for s, _ in fused) * 1e3
                                          / max(1, sum(c for _, c in fused))
                                          if fused else None)
                    row["profiled_launches"] = \
                        kernel.LAUNCHES["fused"] - before
                rows.append(row)
                for key in total:
                    total[key] += row[key] * n * layers / 8
                del a, got, want
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
