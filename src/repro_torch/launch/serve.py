"""Serving entry points, on the card unless `--device cpu` is given:

    # continuous-batching LM engine over synthetic requests
    PYTHONPATH=src python -m repro_torch.launch.serve lm --arch smollm-135m \\
        --full --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve lm --arch mamba2-2.7b \\
        --device cpu

    # DSE-as-a-service demo: N clients submit the same design query
    # concurrently; identical in-flight requests coalesce onto one
    # run_search job and every client streams the same event history
    PYTHONPATH=src python -m repro_torch.launch.serve dse --clients 4 \\
        --strategy exhaustive --goal edp --device cpu

Every family of `configs/registry.py` serves: `dense` (smollm-135m,
minicpm3-4b with MLA, ...), `moe` (granite-moe-1b-a400m,
deepseek-v2-lite-16b), `vlm` (qwen2-vl-2b, token inputs), `encdec`
(whisper-small; the engine leaves `enc_out` zeros, as the reference's
does), `ssm` (mamba2-2.7b) and `hybrid` (zamba2-2.7b).  `--full` serves
the registered configuration at full width with random weights from
`--seed`; without it, the reduced variant.  `--ckpt-dir` serves the
parameters of the latest checkpoint there (`launch/train.py` writes them
as `params/<name>` leaves).
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
    from ..train import checkpoint as ckpt

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve lm")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
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
    if args.ckpt_dir:
        step = ckpt.latest_step(args.ckpt_dir)
        if step is not None:
            like = {f"params/{n}": p for n, p in params.named_parameters()}
            restored = ckpt.restore(args.ckpt_dir, step, like)
            with torch.no_grad():
                for key, p in like.items():
                    p.copy_(restored[key])
            print(f"[serve] restored params from step {step}")
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


def main_dse(argv: Optional[List[str]] = None):
    from ..core import Conv2D, FC, Pool2D, TaskDescription
    from ..obs import Tracer
    from ..search.space import ArchSpace
    from ..serve.dse_service import DSEService, SearchQuery

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve dse")
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent identical submits (coalesce demo)")
    ap.add_argument("--distinct", type=int, default=1,
                    help="additional distinct queries (separate jobs)")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--strategy", default="exhaustive")
    ap.add_argument("--goal", default="edp")
    ap.add_argument("--budget", type=int, default=None)
    ap.add_argument("--constraints", default="",
                    help='e.g. "area_mm2<=5"')
    ap.add_argument("--timeout-s", type=float, default=None)
    ap.add_argument("--cache-dir", default="",
                    help="persistent warm cache tier (shared)")
    ap.add_argument("--stream", action="store_true",
                    help="print every client-0 progress event")
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace of the service here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    task = TaskDescription(
        name="cnn-demo", input_shape=(16, 16, 3), batch_size=4,
        processing_type="Inference",
        layers=(Conv2D(8, (3, 3), (1, 1), (1, 1), name="c1"),
                Pool2D((2, 2), (2, 2), name="p1"),
                FC(10, name="fc")))
    space = ArchSpace.spatial(num_pes=(16, 32, 64), rf_words=(64,),
                              gbuf_words=(2048, 8192), bits=16)

    def query(seed: int = 0) -> SearchQuery:
        return SearchQuery(
            task=task, space=space, goal=args.goal,
            strategy=args.strategy, budget=args.budget, seed=seed,
            constraints=args.constraints or None)

    tracer = Tracer() if args.trace else None
    with DSEService(workers=args.workers,
                    cache=args.cache_dir or None,
                    default_timeout_s=args.timeout_s,
                    tracer=tracer, device=args.device) as svc:
        t0 = time.time()
        tickets = [svc.submit(query()) for _ in range(args.clients)]
        extra = [svc.submit(query(seed=s + 1))
                 for s in range(args.distinct)]
        if args.stream:
            for ev in tickets[0].events(timeout=300.0):
                print(f"  [{ev.kind}] " + " ".join(
                    f"{k}={v}" for k, v in ev.payload.items()))
        for i, tk in enumerate(tickets + extra):
            rep = tk.result(timeout=300.0)
            print(f"[dse] client {i}: "
                  f"{'coalesced' if tk.coalesced else 'admitted'} "
                  f"digest={tk.digest[:12]} best={rep.best.hardware.name} "
                  f"{args.goal}={rep.goal_value():.4e} "
                  f"evaluated={rep.n_evaluated}")
        snap = svc.snapshot()
        print(f"[dse] {time.time() - t0:.1f}s on {svc.device}  stats: "
              + " ".join(f"{k}={v}" for k, v in snap.items()))
    if args.trace and tracer is not None:
        print(f"[dse] trace -> {tracer.export_chrome(args.trace)}")


def main(argv: Optional[List[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "dse":
        return main_dse(argv[1:])
    if argv and argv[0] == "lm":
        return main_lm(argv[1:])
    return main_lm(argv)    # legacy flag-only invocation


if __name__ == "__main__":
    main()
