"""Fault-tolerant checkpointing: atomic, shard-per-host, async (the port
of the JAX package's `train/checkpoint.py`, the same layout on disk).

Layout:  <dir>/step_<N>/
             meta.json            (step, leaf count, extra)
             shard_<host>.npz     (this host's leaves)
         <dir>/LATEST             (atomic pointer, written last)

A tree is a flat mapping of leaf key -> tensor or array
(`TrainState.leaves()` gives the train state's: the model's `state_dict`
names and the optimizer's).  bf16 leaves are stored as float32 (npz has no
bf16) and cast back on restore.

* Writes go to a tmp dir then os.rename (atomic on POSIX) so a crash
  mid-save never corrupts the latest checkpoint (restart-safe).
* `save_async` copies the leaves to the host on the caller's thread, then
  writes them in a daemon thread; `wait()` joins before the next save so
  at most one write is in flight.
* `restore` reads into the structure of a like tree and places each leaf
  on that leaf's device in its dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _host(leaf) -> np.ndarray:
    """One leaf -> a host numpy array of its own (bf16 as float32), so
    that later updates of the leaf do not reach it."""
    if isinstance(leaf, torch.Tensor):
        dtype = torch.float32 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return leaf.detach().to("cpu", dtype, copy=True).numpy()
    return np.array(leaf)


def _flatten(tree: Mapping) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in tree.items()}


def save(ckpt_dir: str, step: int, tree: Mapping,
         extra: Optional[Dict] = None, host_id: int = 0) -> str:
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    leaves = _flatten(tree)
    np.savez(os.path.join(tmp, f"shard_{host_id}.npz"), **leaves)
    meta = {"step": step, "n_leaves": len(leaves), "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(ckpt_dir, ".LATEST_tmp"), "w") as f:
        f.write(str(step))
    os.rename(os.path.join(ckpt_dir, ".LATEST_tmp"),
              os.path.join(ckpt_dir, "LATEST"))
    return final


class AsyncCheckpointer:
    """One in-flight save; blocks the next save until the previous lands.
    Keeps the newest `keep` checkpoints."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree: Mapping, extra=None):
        self.wait()
        host_tree = _flatten(tree)

        def run():
            save(self.dir, step, host_tree, extra)
            self._gc()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore(ckpt_dir: str, step: int, like_tree: Mapping,
            host_id: int = 0) -> Dict[str, torch.Tensor]:
    """-> a new tree with `like_tree`'s keys (name -> tensor), each leaf
    on its like leaf's device in its dtype.  Raises KeyError when the
    checkpoint lacks a leaf and ValueError when a shape differs."""
    path = os.path.join(ckpt_dir, f"step_{step}", f"shard_{host_id}.npz")
    with np.load(path) as data:
        missing = [k for k in like_tree if k not in data.files]
        if missing:
            raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
        out = {}
        for key, leaf in like_tree.items():
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            out[key] = torch.from_numpy(arr).to(leaf.device, leaf.dtype)
    return out
