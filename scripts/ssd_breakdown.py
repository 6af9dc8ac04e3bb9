#!/usr/bin/env python3
"""Where the SSD scan's tensor-core route ("tc") spends its time, on one
CUDA card, at mamba2-2.7b's prefill layer (B=4, T=2048, 80 heads of 64,
N=128, chunk 128) and zamba2-2.7b's (B=1, N=64).

It builds the committed `kernels/ssd_scan/csrc/ssd_scan.cu` and, beside it
under `build/` (git-ignored), copies with one part of the work switched
off, whose results are wrong and only timed:

  no_products     no `wgmma` is issued (the products)
  no_transforms   no TF32 split of C or X^T and no W formed in shared
                  memory (the threads' work between copies and products)
  copies_only     neither: what is left is the copies, the A fragments'
                  split in registers, the epilogues and the other steps

and prints, per variant and layer, one op call's time by CUDA events
(cold L2, median of 10) and each sub-kernel's time a launch by the
profiler, as one JSON line each.

    python3 scripts/ssd_breakdown.py

The timing helpers are this checkout's `chip_smoke.py`.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"

# (text in the source, text with the switch): each must occur once
HOOKS = [
    ("""  wg_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {""", """  wg_fence();
#pragma unroll
  for (int ks = 0; ks < 4 * !SKIP_PRODUCTS; ++ks) {"""),
    ("""  auto transform = [&](int u) {""",
     """  auto transform = [&](int u) {
    if (SKIP_TRANSFORMS) return;"""),
    ("""    for (int pass = 0; pass < P * 8 / WG; ++pass) {""",
     """    for (int pass = 0; pass < P * 8 / WG * !SKIP_TRANSFORMS; ++pass) {"""),
]
VARIANTS = {"committed": None, "no_products": (1, 0), "no_transforms": (0, 1),
            "copies_only": (1, 1)}


def patched(skip_products: int, skip_transforms: int) -> str:
    src = SOURCE.read_text()
    for old, new in HOOKS:
        if src.count(old) != 1:
            raise RuntimeError(f"hook not found once in {SOURCE}: {old!r}")
        src = src.replace(old, new)
    return (f"#define SKIP_PRODUCTS {skip_products}\n"
            f"#define SKIP_TRANSFORMS {skip_transforms}\n" + src)


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_breakdown: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs                    # timing helpers only
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import kernel

    libs = {}
    for name, skips in VARIANTS.items():
        if skips is None:
            libs[name] = kernel.LIBRARY
            continue
        path = build.BUILD_DIR / f"ssd_breakdown_{name}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(patched(*skips))
        libs[name] = build.CudaLibrary(f"ssd_breakdown_{name}", path,
                                       build.SM90A, kernel._bind)
    build.build_all(list(libs.values()))
    dev = torch.device("cuda", 0)
    for case in cs.SSD_CASES[:2]:
        b, t, h, p, g, n, q, what = case
        args = cs._ssd_inputs(b, t, h, p, g, n, dev, what)
        for name, lib in libs.items():
            kernel.LIBRARY = lib
            run = lambda: kernel.ssd_scan_fwd(*args, chunk=q, route="tc")
            ms = cs.device_times_ms(run, n=10, cold=True)
            _, (call_ms, per, _) = cs.ssd_profile(
                lambda: [run() for _ in range(10)],
                cs.ssd_launched("tc", t, q))
            print(json.dumps({
                "layer": what, "variant": name,
                "device": torch.cuda.get_device_name(0),
                "events_ms": ms, "profiler_call_ms": call_ms,
                "sub_kernels_ms": per}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
