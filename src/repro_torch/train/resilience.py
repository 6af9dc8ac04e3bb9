"""Fault tolerance at framework level: elastic re-mesh + straggler monitor
(a copy of the JAX package's `train/resilience.py`; pure Python).

Checkpoint/restart handles hard failures (see checkpoint.py).  This module
covers the two softer production problems:

* **Elastic re-mesh** — a pod loses hosts; training resumes on the survivor
  set.  `plan_remesh` picks the largest (data, model) mesh that (a) fits the
  survivors, (b) keeps the model axis intact (TP degree is a property of the
  compiled program), and (c) keeps global batch divisible.  Restore then
  places the checkpoint on the new mesh — the param tree is
  topology-independent by construction.

* **Straggler mitigation** — per-host step-time EMA; hosts slower than
  `threshold` x median are flagged.  The driver reacts by (1) excluding the
  host at the next elastic re-mesh, or (2) when `backup_steps` is on,
  issuing the step redundantly on the fastest idle host (speculative
  execution, MapReduce-style).  On a single-controller CPU run this is
  exercised with synthetic timings (tests/test_torch_train.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass
class RemeshPlan:
    n_devices: int
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    global_batch: int
    dropped_devices: int


def plan_remesh(n_available: int, *, model_parallel: int,
                global_batch: int, prefer_pods: int = 1) -> RemeshPlan:
    """Largest usable mesh given surviving devices."""
    if n_available < model_parallel:
        raise RuntimeError(
            f"cannot keep TP={model_parallel} with {n_available} devices")
    data = n_available // model_parallel
    # keep global batch divisible by dp degree: shrink dp if needed
    while data > 1 and global_batch % data != 0:
        data -= 1
    used = data * model_parallel
    if prefer_pods > 1 and data % prefer_pods == 0:
        shape = (prefer_pods, data // prefer_pods, model_parallel)
        names = ("pod", "data", "model")
    else:
        shape = (data, model_parallel)
        names = ("data", "model")
    return RemeshPlan(n_devices=used, mesh_shape=shape, axis_names=names,
                      global_batch=global_batch,
                      dropped_devices=n_available - used)


class StragglerMonitor:
    """EMA of per-host step durations; flags hosts above threshold x
    median."""

    def __init__(self, n_hosts: int, alpha: float = 0.2,
                 threshold: float = 1.5, warmup: int = 5):
        self.ema = [0.0] * n_hosts
        self.count = 0
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup

    def record(self, host_times: List[float]):
        for h, t in enumerate(host_times):
            self.ema[h] = t if self.count == 0 else (
                self.alpha * t + (1 - self.alpha) * self.ema[h])
        self.count += 1

    def stragglers(self) -> List[int]:
        if self.count < self.warmup:
            return []
        med = sorted(self.ema)[len(self.ema) // 2]
        return [h for h, t in enumerate(self.ema)
                if t > self.threshold * med]

    def healthy_hosts(self) -> List[int]:
        bad = set(self.stragglers())
        return [h for h in range(len(self.ema)) if h not in bad]


@dataclasses.dataclass
class FailurePolicy:
    """Driver-loop policy: what to do on step failure / straggle."""
    max_retries: int = 2
    checkpoint_every: int = 100
    remesh_on_straggle: bool = True
    backup_steps: bool = False

    def on_failure(self, step: int, attempt: int) -> str:
        if attempt < self.max_retries:
            return "retry"
        return "restore_and_remesh"
