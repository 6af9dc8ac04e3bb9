#!/usr/bin/env python3
"""Time Mamba2's conv-chain kernel (`kernels/ssm_conv`) beside its plain
version (`ref.conv_chain`, the eager chain) and its byte bound, on one CUDA
card, at mamba2-2.7b's layer (d_inner 5120, G N 128, H 80, K 4, bf16) for
each call shape of the benchmark's `code-4k` cycle, and at zamba2-2.7b's
layer (G N 64) at [4, 2048]:

  * CUDA events around one call enqueued behind a spin kernel, with a cold
    L2 (a 256 MB buffer read before each call) and a warm one, median of
    `chip_smoke.N_TIMED` (`chip_smoke.device_times_ms`);
  * torch.profiler's device time of the kernel a launch at [4, 2048];
  * the bound: the bytes the chain must move (its bf16 input and float32
    output of C + H columns a token, the weights once) at 3.35 TB/s
    (`chip_smoke.conv_bound_ms`);
  * per model call of the cycle (64 layers, the 8 calls' mean): the
    kernel's and the plain version's summed cold times.

    python3 scripts/ssm_conv_timing.py [--out FILE]

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
LAYERS = 64
DI, H, K = 5120, 80, 4


def _inputs(b, t, gn, dev, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    c = DI + 2 * gn

    def z(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    return (z(b, t, 2 * DI + 2 * gn + H), z(K, c, scale=K ** -0.5),
            z(c, scale=0.1), z(H, scale=0.5))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssm_conv_timing: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import conv_bound_ms, device_busy, device_times_ms
    from repro_torch.kernels.ssm_conv import kernel, ops, ref
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rows, per_call = [], {"kernel_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    shapes = [(bt, n, 128, "mamba2-2.7b") for bt, n in CYCLE] \
        + [((4, 2048), 0, 64, "zamba2-2.7b")]
    with torch.no_grad():
        for (b, t), n, gn, model in shapes:
            a = _inputs(b, t, gn, dev)
            run = lambda: ops.ssm_conv(*a, d_inner=DI, gn=gn)  # noqa: E731
            plain = lambda: ref.conv_chain(*a, DI, gn)        # noqa: E731
            got, want = run()[1], plain()[1]
            err = float((got - want).abs().max())
            ms = device_times_ms(run, cold=True)
            warm = device_times_ms(run)
            plain_ms = device_times_ms(plain, cold=True)
            bound = conv_bound_ms(b, t, DI + 2 * gn, H, K)
            row = dict(model=model, shape=[b, t], kernel_ms=ms,
                       kernel_warm_ms=warm, plain_ms=plain_ms,
                       bound_ms=bound, share_of_bound=bound / ms,
                       max_abs_vs_bf16_chain=err)
            if (b, t) == (4, 2048):
                before = kernel.LAUNCHES["fused"]
                busy = device_busy(lambda: [run() for _ in range(10)])[4]
                fused = [(s, c) for name, (s, c) in busy.items()
                         if "ssm_conv_kernel" in name]
                row["profiler_ms"] = (sum(s for s, _ in fused) * 1e3
                                      / max(1, sum(c for _, c in fused))
                                      if fused else None)
                row["profiled_launches"] = kernel.LAUNCHES["fused"] - before
            rows.append(row)
            for key in per_call:
                per_call[key] += row[key] * n * LAYERS / 8
            del a
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
