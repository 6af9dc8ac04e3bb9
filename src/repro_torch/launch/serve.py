"""Serving entry point: the continuous-batching LM engine over synthetic
requests, on the card unless `--device cpu` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve lm --arch smollm-135m \\
        --full --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve lm --arch mamba2-2.7b \\
        --device cpu

Every ported family serves: `dense` (smollm-135m, ...), `ssm`
(mamba2-2.7b) and `hybrid` (zamba2-2.7b).  `--full` serves the
registered configuration at full width with random weights from `--seed`;
without it, the reduced variant.  The reference's
`dse` subcommand (the design-space service) is not ported yet (ROADMAP
queue 1, item 4), nor is `--ckpt-dir` (training's checkpoints, item 8).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def main_lm(argv: Optional[List[str]] = None):
    import numpy as np
    import torch

    from ..configs import get_config, reduced_config
    from ..device import as_device
    from ..models import init_model
    from ..serve.engine import Request, ServeEngine

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve lm")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = as_device(args.device)
    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    params = init_model(cfg, torch.Generator().manual_seed(args.seed),
                        device=dev)
    engine = ServeEngine(cfg, params, batch=args.batch,
                         max_len=args.max_len, device=dev)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab,
                              size=int(rng.integers(2, 12)))
        engine.submit(Request(rid=rid, prompt=prompt.astype(np.int32),
                              max_new_tokens=args.max_new_tokens))
    ticks = engine.run_until_drained()
    dt = time.time() - t0
    total_toks = sum(len(r.out_tokens) for r in engine.done.values())
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"[serve] {cfg.name}: {len(engine.done)} requests, {total_toks} "
          f"tokens, {ticks} ticks, {dt:.1f}s "
          f"({total_toks / max(dt, 1e-9):.1f} tok/s on {where})")


def main(argv: Optional[List[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "dse":
        raise NotImplementedError("the dse service is not ported yet "
                                  "(ROADMAP queue 1, item 4)")
    if argv and argv[0] == "lm":
        return main_lm(argv[1:])
    return main_lm(argv)    # legacy flag-only invocation


if __name__ == "__main__":
    main()
