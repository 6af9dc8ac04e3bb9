#!/usr/bin/env python3
"""Checks of granite-4.0-h-small on one card that the benchmark's run does
not make: decode through the cache against the plain float32 reference,
and how often the bf16 program's routing agrees with the reference's.

    python3 scripts/granite_checks.py --seed <n> [--route-shape 2,4096]

Run from the root of a checkout on a machine with an H100.  Weights come
from the seed as `portbench/run.py` makes them (the cell
`granite-4.0-h-small.code-4k`), and the program is the benchmark's.

* decode: a prompt of `--prompt` tokens for `--batch` rows, fed token by
  token through `init_cache` and `decode_step` (as `ServeEngine` prefills),
  then `--steps` greedy steps; each step's logits against the reference's
  `forward_last` over the tokens so far (its SSD scan at chunk 1, which
  changes no value and takes any length), by the cell's compared numbers
  and limits; the prompt's last logits also against the program's prefill.
* routing: one call of `--route-shape` through the program's prefill and
  the reference, each MoE layer's top-k experts a token recorded; the share
  of (layer, token) whose top-k sets are equal, a layer's share, and the
  share of the program's (layer, token, expert) choices that the
  reference's top-k holds.
* engine: `ServeEngine` answers two requests on the card.

One JSON line a check, then a summary line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELL = "granite-4.0-h-small.code-4k"


def build(cell, weights):
    """(ModelConfig, the program's model holding `weights`), as
    `harness.program` builds them."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import init_model
    mc = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in cell.model.items()})
    model = init_model(mc, device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    model.requires_grad_(False)
    flash_ops.install()
    return mc, model


def reference_last(cell, weights, tokens):
    """The reference's last-position logits, its scan at chunk 1."""
    import torch
    from portbench.reference.plain import Products, float32_exact
    m = dict(cell.reference_model, chunk=1)
    with torch.no_grad(), float32_exact():
        return cell.reference.forward_last(weights, m, tokens, Products())


def decode_check(cell, weights, mc, model, seed, batch, prompt, steps, h):
    import torch
    from repro_torch.models import decode_step, forward, init_cache
    gen = torch.Generator().manual_seed(h.derive(seed, "decode"))
    dev = weights["embed"].device
    toks = torch.randint(0, cell.config["token_ids"], (batch, prompt),
                         generator=gen).to(dev)
    limits = cell.limits["limits"]
    cache = init_cache(mc, batch, prompt + steps, device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        for pos in range(prompt):
            logits, cache = decode_step(model, mc, cache, toks[:, pos], pos)
        prefill = forward(model, mc, {"tokens": toks},
                          logits_mode="last")[:, 0]
    rows = [{"step": "prompt", "S": prompt,
             "vs_prefill": h.compare(logits, prefill.float()),
             "vs_reference": h.compare(logits, reference_last(
                 cell, weights, toks))}]
    seq = toks
    for step in range(steps):
        nxt = logits.float().argmax(-1)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
        with torch.no_grad():
            logits, cache = decode_step(model, mc, cache, nxt,
                                        prompt + step)
        rows.append({"step": step, "S": seq.shape[1],
                     "vs_reference": h.compare(logits, reference_last(
                         cell, weights, seq))})
    worst = {}
    for r in rows:
        worst = h.worst(worst, r["vs_reference"])
    return {"check": "decode", "batch": batch, "prompt": prompt,
            "steps": steps, "seconds": time.perf_counter() - t0,
            "rows": rows, "worst_vs_reference": worst, "limits": limits,
            "within_limits": all(worst[k] <= v for k, v in limits.items())}


def route_check(cell, weights, mc, model, seed, shape, h):
    import torch
    from portbench.reference.plain import Products, float32_exact
    from repro_torch.models import forward
    from repro_torch.models import moe as moe_mod
    gen = torch.Generator().manual_seed(h.derive(seed, "route"))
    toks = torch.randint(0, cell.config["token_ids"], shape,
                         generator=gen).to(weights["embed"].device)
    prog, ref = [], []
    route, ref_route = moe_mod._route, cell.reference.route

    def prog_route(xt, router, cfg):
        out = route(xt, router, cfg)
        prog.append(out[2].sort(-1).values.cpu())
        return out

    def rec_route(logits, k):
        out = ref_route(logits, k)
        ref.append(out[1].sort(-1).values.cpu())
        return out
    moe_mod._route, cell.reference.route = prog_route, rec_route
    try:
        with torch.no_grad():
            logits = forward(model, mc, {"tokens": toks},
                             logits_mode="last")[:, 0]
        with torch.no_grad(), float32_exact():
            want = cell.reference.forward_last(weights, cell.reference_model,
                                               toks, Products())
    finally:
        moe_mod._route, cell.reference.route = route, ref_route
    same = [(p == r).all(-1).float() for p, r in zip(prog, ref)]
    held = [(p[:, :, None] == r[:, None, :]).any(-1).float().mean().item()
            for p, r in zip(prog, ref)]
    share = torch.stack(same).mean().item()
    return {"check": "route", "shape": list(shape), "layers": len(prog),
            "sets_equal_share": share,
            "by_layer": [round(s.mean().item(), 4) for s in same],
            "choices_held_share": sum(held) / len(held),
            "logits": h.compare(logits, want)}


def engine_check(mc, model):
    import numpy as np
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(mc, model, batch=2, max_len=64,
                      device=model.embed.device)
    rng = np.random.default_rng(0)
    for rid in range(2):
        eng.submit(Request(rid, rng.integers(0, mc.vocab, 16,
                                             dtype=np.int32), 4))
    t0 = time.perf_counter()
    eng.run_until_drained()
    return {"check": "engine", "requests": len(eng.done),
            "tokens": [len(r.out_tokens) for r in eng.done.values()],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--route-shape", default="2,4096")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench import harness as h
    from portbench.run import require_cards
    cell = h.load_cell(ROOT, CELL)
    require_cards(cell.chips)
    device = torch.device("cuda", 0)
    weights = h.make_weights(cell.reference.PARAMS(cell.model),
                             torch.bfloat16, args.seed, device)
    mc, model = build(cell, weights)
    shape = tuple(int(v) for v in args.route_shape.split(","))
    lines = [route_check(cell, weights, mc, model, args.seed, shape, h),
             decode_check(cell, weights, mc, model, args.seed, args.batch,
                          args.prompt, args.steps, h),
             engine_check(mc, model)]
    for line in lines:
        print(json.dumps(line), flush=True)
    print(json.dumps({"seed": args.seed,
                      "device": torch.cuda.get_device_name(device),
                      "route_sets_equal": lines[0]["sets_equal_share"],
                      "decode_within_limits": lines[1]["within_limits"],
                      "engine_requests": lines[2]["requests"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
