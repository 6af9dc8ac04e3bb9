"""Deterministic, restartable data pipeline (a copy of the JAX package's
`data/pipeline.py`; numpy only).

Two sources:
  * SyntheticLM — seeded zipfian token stream (CI / dry-run / examples);
  * MemmapTokens — flat binary token file (np.memmap), the production path.

Both are *stateless by index*: batch i is a pure function of (seed, i), so
restart-after-failure resumes exactly by restoring the step counter from the
checkpoint — no iterator state to persist.  Per-host sharding slices the
global batch by host rank (host h reads rows [h*B/H, (h+1)*B/H)).  Batches
stay numpy arrays on the host; the train loop copies them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    path: Optional[str] = None        # memmap token file (None => synthetic)
    num_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    """Zipf-distributed tokens with a learnable bigram structure (so loss
    actually decreases in the end-to-end example)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._next = rng.permutation(cfg.vocab)    # deterministic bigram map

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b_local = cfg.global_batch // cfg.num_hosts
        rng = np.random.default_rng((cfg.seed, index, cfg.host_id))
        zipf = rng.zipf(1.3, size=(b_local, cfg.seq_len))
        toks = np.minimum(zipf, cfg.vocab - 1).astype(np.int32)
        # inject bigram structure on even positions
        toks[:, 1::2] = self._next[toks[:, 0::2][:, :toks[:, 1::2].shape[1]]]
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


class MemmapTokens:
    """Flat int32 token file; batch i = contiguous strided window."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=np.int32, mode="r")
        self.n_windows = (len(self.data) - 1) // cfg.seq_len

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b_local = cfg.global_batch // cfg.num_hosts
        rng = np.random.default_rng((cfg.seed, index))
        starts = rng.integers(0, self.n_windows,
                              size=cfg.global_batch) * cfg.seq_len
        lo = cfg.host_id * b_local
        rows = [np.asarray(self.data[s:s + cfg.seq_len])
                for s in starts[lo:lo + b_local]]
        return {"tokens": np.stack(rows).astype(np.int32)}


def make_source(cfg: DataConfig):
    return MemmapTokens(cfg) if cfg.path else SyntheticLM(cfg)
