#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (`src/repro_torch`): one run
of one cell of `BENCHMARK.json`.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell asks
for.  It makes the weights and prompts from `--seed`, warms up the cell's
shape, drives the program's prefill in a closed loop for `--seconds`, checks
a sample of the window's logits against the plain float32 reference, and
prints one JSON line last on standard output: with `--trace 0` the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics (from a profiled
stretch after the window) and the device's busy time.  The numbers compared
and their limits are the last lines on standard error.  It exits non-zero,
printing no result, without the cards, without the program, or when a
module of the JAX stack or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout (git-ignored)
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def require_cards(chips: int) -> None:
    """Raise SystemExit unless `chips` CUDA cards are visible."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), "
              f"{n} visible", file=sys.stderr)
        raise SystemExit(3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    from portbench import harness
    cell = harness.load_cell(ROOT, args.workload)
    require_cards(cell.chips)
    import torch
    result, lines = harness.run(cell, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0),
                                T0)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"portbench: modules of the JAX stack or package loaded: "
              f"{found}", file=sys.stderr)
        return 4
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
