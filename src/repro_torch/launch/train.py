"""Training driver: data pipeline -> sharded train loop with
checkpointing, resume and straggler monitoring (the port of the JAX
package's `launch/train.py`), on the card unless `--device cpu` is given:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4
    PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.train \\
        --device cpu --mesh 2,2 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --full \\
        --seq-len 2048 --global-batch 8 --microbatches 2 \\
        --remat dots_no_batch --ckpt-dir /tmp/ckpt

Every mesh, (1, 1) included, runs the sharded step of `launch/steps.py`
on DTensors over a (data, model) `DeviceMesh` (`launch/mesh.py`: NCCL for
the card, gloo for the CPU; started from torchrun's environment, or as a
world of one process).  `--sharding trim` takes the TRIM planner's
overrides of the logical rules (`core.tpu_adapter.trim_sharding_overrides`).
Only rank 0 prints and writes checkpoints; every rank gathers the leaves
(`full_tensor()` is a collective) and waits for the last checkpoint.  Like the reference's, the loop never
installs the flash-attention hook: attention trains on its plain path and
the Mamba2 layers on their differentiable scan.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs import get_config, reduced_config
from ..configs.shapes import ShapeSpec
from ..data.pipeline import DataConfig, make_source
from ..device import as_device
from ..parallel.sharding import make_rules
from ..train import checkpoint as ckpt
from ..train.optimizer import OptConfig
from ..train.resilience import FailurePolicy, StragglerMonitor
from ..train.train_step import TrainConfig
from .mesh import make_mesh
from .steps import build_train_step, init_sharded_params, init_sharded_state


def _full_leaves(state):
    """Every leaf of the state as a full tensor (a collective for each
    DTensor leaf: every rank calls it)."""
    return {k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in state.leaves().items()}


def train_loop(*, arch: str, steps: int, seq_len: int, global_batch: int,
               reduced: bool = True, mesh_shape=(1, 1),
               ckpt_dir: str = "", lr: float = 3e-4,
               microbatches: int = 1, remat: str = "none",
               log_every: int = 10, resume: bool = True,
               sharding: str = "baseline", device="cuda") -> List[float]:
    """Train `arch` (its reduced variant unless `reduced=False`) for
    `steps` steps on synthetic data on a (data, model) mesh of
    `mesh_shape`, from parameters drawn from a CPU generator seeded with
    0; checkpoint every `max(steps // 4, 10)` steps and at the end into
    `ckpt_dir`, resuming from its `LATEST` when `resume`.  A process group
    that the loop starts (a world of one) is destroyed when it returns.
    -> the losses of the steps run."""
    dev = as_device(device)
    started = not dist.is_initialized()
    try:
        return _train(arch, steps, seq_len, global_batch, reduced,
                      mesh_shape, ckpt_dir, lr, microbatches, remat,
                      log_every, resume, sharding, dev)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(arch, steps, seq_len, global_batch, reduced, mesh_shape,
           ckpt_dir, lr, microbatches, remat, log_every, resume, sharding,
           dev) -> List[float]:
    cfg = reduced_config(arch) if reduced else get_config(arch)
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device=dev)
    spec = ShapeSpec("custom", seq_len, global_batch, "train")
    overrides = {}
    if sharding == "trim":
        from ..core.tpu_adapter import trim_sharding_overrides
        overrides = trim_sharding_overrides(
            cfg, spec, dict(zip(mesh.mesh_dim_names, mesh.shape)))
    elif sharding != "baseline":
        raise ValueError(f"sharding {sharding!r}: baseline or trim")
    rules = make_rules(mesh, overrides=overrides)
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                        total_steps=steps)
    tc = TrainConfig(remat=remat, microbatches=microbatches)
    data = make_source(DataConfig(seq_len=seq_len,
                                  global_batch=global_batch,
                                  vocab=cfg.vocab))
    step_fn, _, placements = build_train_step(cfg, mesh, rules, spec,
                                              opt_cfg=opt_cfg, tc=tc)
    params = init_sharded_params(cfg, mesh, placements.params, device=dev)
    state = init_sharded_state(params, opt_cfg, tc, mesh, placements)
    rank0 = dist.get_rank() == 0

    start = 0
    saver = None
    if ckpt_dir:
        saver = ckpt.AsyncCheckpointer(ckpt_dir) if rank0 else None
        last = ckpt.latest_step(ckpt_dir) if resume else None
        if last is not None:
            state.load_leaves(ckpt.restore(ckpt_dir, last, state.leaves()))
            start = last
            if rank0:
                print(f"[train] resumed from step {start}")

    monitor = StragglerMonitor(n_hosts=1)
    policy = FailurePolicy(checkpoint_every=max(steps // 4, 10))
    losses = []
    for step in range(start, steps):
        t0 = time.time()
        state, metrics = step_fn(state, data.batch(step))
        loss = float(metrics["loss"])
        losses.append(loss)
        monitor.record([time.time() - t0])
        if rank0 and (step % log_every == 0 or step == steps - 1):
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"lr {metrics['lr']:.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"dt {time.time() - t0:.2f}s", flush=True)
        if ckpt_dir and (step + 1) % policy.checkpoint_every == 0:
            leaves = _full_leaves(state)
            if saver:
                saver.save_async(step + 1, leaves)
    if ckpt_dir:
        leaves = _full_leaves(state)
        if saver:
            saver.wait()
            saver.save_async(steps, leaves)
            saver.wait()
        # no rank returns before the checkpoint is whole: a resume reads
        # the same `LATEST` on every rank
        dist.barrier()
    return losses


def _mesh(text: str):
    return tuple(int(a) for a in text.split(","))


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="full config (default: reduced)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--mesh", type=_mesh, default=(1, 1),
                    help="data,model (their product is the world size)")
    ap.add_argument("--sharding", choices=["baseline", "trim"],
                    default="baseline")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    losses = train_loop(arch=args.arch, steps=args.steps,
                        seq_len=args.seq_len,
                        global_batch=args.global_batch,
                        reduced=not args.full, mesh_shape=args.mesh,
                        ckpt_dir=args.ckpt_dir,
                        microbatches=args.microbatches, remat=args.remat,
                        sharding=args.sharding,
                        device=args.device)
    if int(os.environ.get("RANK", 0)) == 0:
        print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
