"""Production-mesh dry-run on a fake process group: build every (arch x
shape) step on the 16 x 16 (256 ranks) or 2 x 16 x 16 (512 ranks) mesh,
run it once on meta-device shards (no allocation, no card) and record the
memory, the cost, the collective schedule and the roofline (the port of
the JAX package's `launch/dryrun.py`, which lowers and compiles on 512
host devices).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out experiments/dryrun_torch

One process plays rank 0 of the world: the "fake" backend of
`torch.testing._internal.distributed.fake_pg` (a testing-internal module
of torch, present in 2.11 and 2.13) answers every collective at once, and
the tensors live on the meta device, so each rank's shapes, FLOPs, bytes
and collectives are counted without data.  Per cell:

* `memory.argument_bytes`: the local shard bytes of the state (params and
  optimizer state, or params and cache) and the batch;
* `memory.temp_bytes`: the local bytes autograd saves for the backward
  pass (`saved_tensors_hooks`, each tensor once, parameters excluded); 0
  for inference;
* `cost`, `collectives`, `roofline`: from `roofline.count_costs` and
  `collective_stats` (per device), with the card's constants;
* `trace_s`: the wall time of building and running the traced step (in
  place of the reference's `lower_s` / `compile_s`).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs import ARCHS, SHAPES, get_config, is_skipped
from ..models import init_cache
from ..parallel.sharding import make_rules
from ..train.optimizer import OptConfig
from ..train.train_step import TrainConfig
from . import roofline as rl
from .mesh import make_production_mesh
from .steps import (build_decode_step, build_prefill_step, build_train_step,
                    init_sharded_params, init_sharded_state, place,
                    place_tree)


@contextlib.contextmanager
def fake_world(n: int):
    """A default process group of `n` ranks on the fake backend, this
    process rank 0; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run needs a process group of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(t) -> int:
    if isinstance(t, DTensor):
        t = t.to_local()
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, dict):
        return sum(_local_bytes(v) for v in t.values())
    if isinstance(t, (list, tuple)):
        return sum(_local_bytes(v) for v in t)
    return 0


class SavedBytes:
    """Counts the local bytes autograd saves for backward (each tensor
    object once; parameters are arguments, not temporaries)."""

    def __init__(self):
        self.bytes = 0
        self._seen = set()

    def pack(self, t):
        if not isinstance(t, torch.nn.Parameter) and id(t) not in self._seen:
            self._seen.add(id(t))
            self.bytes += _local_bytes(t)
        return t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                        lambda t: t)


def run_cell(arch: str, shape: str, *, multi_pod: bool,
             sharding_mode: str = "baseline", remat: str = "dots_no_batch",
             mla_absorb: bool = False, seq_shard: Optional[bool] = None,
             fsdp: bool = True, grad_compression: bool = False,
             microbatches: int = 0) -> dict:
    cfg = get_config(arch)
    spec = SHAPES[shape]
    mesh_name = "multi" if multi_pod else "single"
    if is_skipped(cfg, shape):
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "skipped": ("full-attention arch: long_500k requires "
                            "sub-quadratic attention (DESIGN.md §5)")}
    if seq_shard is None:
        seq_shard = spec.global_batch < 8     # SP for tiny-batch long ctx
    if microbatches == 0:
        # production default: 4-way gradient accumulation for training
        microbatches = 4 if spec.kind == "train" else 1
    n_dev = 512 if multi_pod else 256
    with fake_world(n_dev):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        overrides = {}
        if sharding_mode == "trim":
            from ..core.tpu_adapter import trim_sharding_overrides
            overrides = trim_sharding_overrides(
                cfg, spec, dict(zip(mesh.mesh_dim_names, mesh.shape)))
        rules = make_rules(mesh, fsdp=fsdp, seq_shard=seq_shard,
                           overrides=overrides)
        saved = SavedBytes()
        t0 = time.time()
        if spec.kind == "train":
            opt_cfg = OptConfig()
            tc = TrainConfig(remat=remat, grad_compression=grad_compression,
                             microbatches=microbatches)
            fn, (_, in_specs), tp = build_train_step(
                cfg, mesh, rules, spec, opt_cfg=opt_cfg, tc=tc)
            params = init_sharded_params(cfg, mesh, tp.params, device="meta")
            state = init_sharded_state(params, opt_cfg, tc, mesh, tp)
            batch = {k: place(v, mesh, tp.batch[k])
                     for k, v in in_specs.items()}
            args_bytes = _local_bytes(state.leaves()) + _local_bytes(batch)
            with saved.hooks():
                (state, metrics), mode = rl.count_costs(fn, state, batch)
            out_bytes = _local_bytes(state.leaves()) + _local_bytes(
                {k: v for k, v in metrics.items() if k != "lr"})
        elif spec.kind == "prefill":
            fn, (_, in_specs), (p_pl, b_pl) = build_prefill_step(
                cfg, mesh, rules, spec, remat="none")
            params = init_sharded_params(cfg, mesh, p_pl, device="meta")
            batch = {k: place(v, mesh, b_pl[k]) for k, v in in_specs.items()}
            args_bytes = _local_bytes(dict(params.named_parameters())) \
                + _local_bytes(batch)
            logits, mode = rl.count_costs(fn, params, batch)
            out_bytes = _local_bytes(logits)
        else:
            fn, (_, _, token, _), (p_pl, c_pl, t_pl) = build_decode_step(
                cfg, mesh, rules, spec, mla_absorb=mla_absorb)
            params = init_sharded_params(cfg, mesh, p_pl, device="meta")
            cache = place_tree(init_cache(cfg, spec.global_batch,
                                          spec.seq_len, device="meta"),
                               c_pl, mesh)
            token = place(token, mesh, t_pl)
            args_bytes = _local_bytes(dict(params.named_parameters())) \
                + _local_bytes(cache) + _local_bytes(token)
            (logits, cache), mode = rl.count_costs(
                fn, params, cache, token, spec.seq_len // 2)
            out_bytes = _local_bytes(logits) + _local_bytes(cache)
        trace_s = time.time() - t0
    coll = rl.collective_stats(mode, n_dev)
    model_flops = rl.model_flops_estimate(cfg, spec)
    roof = rl.make_roofline(flops_per_device=mode.flops,
                            bytes_per_device=mode.bytes,
                            collective_bytes=coll.total_transfer,
                            model_flops=model_flops, n_devices=n_dev)
    return {
        "arch": arch, "shape": shape, "mesh": mesh_name,
        "n_devices": n_dev,
        "sharding": sharding_mode,
        "remat": remat,
        "options": {"mla_absorb": mla_absorb, "seq_shard": seq_shard,
                    "fsdp": fsdp, "grad_compression": grad_compression,
                    "microbatches": microbatches},
        "trace_s": round(trace_s, 2),
        "memory": {"argument_bytes": args_bytes,
                   "output_bytes": out_bytes,
                   "temp_bytes": saved.bytes,
                   "peak_bytes": saved.bytes + args_bytes},
        "cost": {"flops_per_device": mode.flops,
                 "bytes_per_device": mode.bytes},
        "collectives": {"counts": coll.counts,
                        "result_bytes": coll.result_bytes,
                        "transfer_bytes_per_device": coll.total_transfer},
        "roofline": roof.as_dict(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--sharding", choices=["baseline", "trim"],
                    default="baseline")
    ap.add_argument("--remat", default="dots_no_batch")
    ap.add_argument("--mla-absorb", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                try:
                    res = run_cell(arch, shape, multi_pod=mp,
                                   sharding_mode=args.sharding,
                                   remat=args.remat,
                                   mla_absorb=args.mla_absorb,
                                   grad_compression=args.grad_compression,
                                   microbatches=args.microbatches)
                    status = "SKIP" if "skipped" in res else "OK"
                except Exception as e:  # noqa: BLE001 - record and go on
                    res = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    status = "FAIL"
                    failures += 1
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                extra = ""
                if status == "OK":
                    r = res["roofline"]
                    extra = (f"trace={res['trace_s']:.0f}s "
                             f"bottleneck={r['bottleneck']} "
                             f"frac={r['roofline_fraction']:.3f}")
                print(f"[{status}] {tag} {extra}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
