#!/usr/bin/env python3
"""Time a model's prefill `forward(tokens [B, 2048], logits_mode="last")`
with the flash hook installed, at full width (bf16, random weights from
seed 0), on one CUDA card, for the `repro_torch` found under `--src`:
smollm-135m at B = 4 (the default), mamba2-2.7b at B = 4 or zamba2-2.7b at
B = 1 (`--arch`; weights from a CUDA generator, as `chip_smoke.py` makes
them), or the MoE models granite-moe-1b-a400m and deepseek-v2-lite-16b at
B = 4 (the kernel timed: the MoE dispatch's cumsum, `tensor_kernel_scan*`):

  * host clock: one call from an idle device to the end of its work, and
    the part of it until `forward` returns (the host enqueueing it);
  * CUDA events around a call enqueued behind a spin kernel (the device's
    time, where the launch queue holds the whole call);
  * the device's busy time and op count under torch.profiler, and the
    device time of the model's hand-written kernel in it (flash attention
    for smollm, the SSD op's kernels for the Mamba2 models), then the
    host clock and the events once more, after the profiler has run in
    the process (as it has before `chip_smoke.py`'s serve phase);
  * for smollm, the host's enqueue time of one flash-attention call at
    the prefill's shape (B=4, S=2048, 9/3 heads of 64); the top operators
    by self CPU time.

    python3 scripts/prefill_timing.py [--src DIR] [--label NAME] [--arch A]

It prints one JSON line.  Run it for two checkouts in one call, in turns
(A, B, B, A), to compare them on one card; the timing helpers are this
checkout's `chip_smoke.py`.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
S, N = 2048, 10
# batch rows of the prefill, the kernel timed and the part of its name
# that the profiler's kernel names contain, per model
ARCHS = {"smollm-135m": (4, "flash", "flash_fwd"),
         "mamba2-2.7b": (4, "ssd", "ssd_"), "zamba2-2.7b": (1, "ssd", "ssd_"),
         "granite-moe-1b-a400m": (4, "scan", "tensor_kernel_scan"),
         "deepseek-v2-lite-16b": (4, "scan", "tensor_kernel_scan")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--arch", default="smollm-135m", choices=sorted(ARCHS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prefill_timing: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                    # timing helpers only
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import attention, forward, init_model

    cfg = get_config(args.arch)
    b, kernel, kernel_name = ARCHS[args.arch]
    gen = (torch.Generator().manual_seed(0) if cfg.family == "dense"
           else torch.Generator("cuda").manual_seed(0))
    model = init_model(cfg, gen, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, S))).to("cuda")
    prefill = lambda: forward(model, cfg, {"tokens": tokens},
                              logits_mode="last")
    with torch.no_grad():
        ops.install()
        try:
            events_ms = cs.device_times_ms(prefill, n=N)
            host_ms, enqueue_ms = cs.host_times_ms(prefill, n=N)
            _, busy, n_ops, _, by_name = cs.device_busy(prefill)
            host_after_ms, enqueue_after_ms = cs.host_times_ms(prefill, n=N)
            events_after_ms = cs.device_times_ms(prefill, n=N)
            kernel_s = sum(t for name, (t, _) in by_name.items()
                           if kernel_name in name)
            enq = []
            if cfg.family == "dense":
                q, k, v = cs._qkv(b, S, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.d_head, torch.bfloat16,
                                  torch.device("cuda"))
                ops.flash_attention(q, k, v)
                for _ in range(30):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ops.flash_attention(q, k, v)
                    enq.append((time.perf_counter() - t0) * 1e6)
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                prefill()
                torch.cuda.synchronize()
        finally:
            attention.set_flash_impl(None)
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print(json.dumps({
        "label": args.label, "repro_torch": repro_torch.__file__,
        "arch": args.arch, "batch": b,
        "device": torch.cuda.get_device_name(0),
        "host_ms": host_ms, "enqueue_ms": enqueue_ms, "events_ms": events_ms,
        "device_busy_ms": busy * 1e3, "device_ops": n_ops,
        "after_profiler": {"host_ms": host_after_ms,
                           "enqueue_ms": enqueue_after_ms,
                           "events_ms": events_after_ms},
        f"{kernel}_device_ms": kernel_s * 1e3,
        "flash_enqueue_us": statistics.median(enq) if enq else None,
        "host_top_self_ms": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                             for e in top[:8]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
