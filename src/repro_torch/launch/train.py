"""Training driver: data pipeline -> train loop with checkpointing, resume
and straggler monitoring (the port of the JAX package's
`launch/train.py`), on the card unless `--device cpu` is given:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --full \\
        --seq-len 2048 --global-batch 8 --microbatches 2 \\
        --remat dots_no_batch --ckpt-dir /tmp/ckpt

One device only: a mesh other than all ones raises until the sharding
rules are ported (ROADMAP queue 1, item 9).  Like the reference's, the
loop never installs the flash-attention hook: attention trains on its
plain path and the Mamba2 layers on their differentiable scan.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from ..configs import get_config, reduced_config
from ..data.pipeline import DataConfig, make_source
from ..device import as_device, to_device
from ..models import init_model
from ..train import checkpoint as ckpt
from ..train.optimizer import OptConfig, init_opt_state
from ..train.resilience import FailurePolicy, StragglerMonitor
from ..train.train_step import TrainConfig, TrainState, make_train_step


def train_loop(*, arch: str, steps: int, seq_len: int, global_batch: int,
               reduced: bool = True, mesh_shape=(1, 1),
               ckpt_dir: str = "", lr: float = 3e-4,
               microbatches: int = 1, remat: str = "none",
               log_every: int = 10, resume: bool = True,
               device="cuda") -> List[float]:
    """Train `arch` (its reduced variant unless `reduced=False`) for
    `steps` steps on synthetic data from parameters drawn from a CPU
    generator seeded with 0; checkpoint every `max(steps // 4, 10)` steps
    and at the end into `ckpt_dir`, resuming from its `LATEST` when
    `resume`.  -> the losses of the steps run."""
    dev = as_device(device)
    if any(int(a) != 1 for a in mesh_shape):
        raise NotImplementedError(
            f"mesh_shape {tuple(mesh_shape)}: the port trains on one device "
            f"until the sharding rules are ported (ROADMAP queue 1, item 9)")
    cfg = reduced_config(arch) if reduced else get_config(arch)
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                        total_steps=steps)
    tc = TrainConfig(remat=remat, microbatches=microbatches)
    data = make_source(DataConfig(seq_len=seq_len,
                                  global_batch=global_batch,
                                  vocab=cfg.vocab))
    step_fn = make_train_step(cfg, opt_cfg, tc)
    params = init_model(cfg, torch.Generator().manual_seed(0), device=dev)
    state = TrainState(params, init_opt_state(opt_cfg, params), None)

    start = 0
    saver = None
    if ckpt_dir:
        saver = ckpt.AsyncCheckpointer(ckpt_dir)
        last = ckpt.latest_step(ckpt_dir) if resume else None
        if last is not None:
            state.load_leaves(ckpt.restore(ckpt_dir, last, state.leaves()))
            start = last
            print(f"[train] resumed from step {start}")

    monitor = StragglerMonitor(n_hosts=1)
    policy = FailurePolicy(checkpoint_every=max(steps // 4, 10))
    losses = []
    for step in range(start, steps):
        t0 = time.time()
        batch = {k: to_device(v, dev) for k, v in data.batch(step).items()}
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        monitor.record([time.time() - t0])
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"lr {metrics['lr']:.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"dt {time.time() - t0:.2f}s", flush=True)
        if saver and (step + 1) % policy.checkpoint_every == 0:
            saver.save_async(step + 1, state.leaves())
    if saver:
        saver.wait()
        saver.save_async(steps, state.leaves())
        saver.wait()
    return losses


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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    losses = train_loop(arch=args.arch, steps=args.steps,
                        seq_len=args.seq_len,
                        global_batch=args.global_batch,
                        reduced=not args.full, ckpt_dir=args.ckpt_dir,
                        microbatches=args.microbatches, remat=args.remat,
                        device=args.device)
    print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
