"""Backend dispatch for mapspace scoring: one entry point, two engines.

`score_mapspace` scores a batch of mappings (all on one hardware/workload
pair) on an explicit `device` and routes each mapping to one of two
numerically matched engines:

  * ``torch`` — `core.batch_eval.evaluate_batch`, the plain vectorized
    oracle (every row, bypass rows included);
  * ``cuda``  — `kernels.mapspace_eval`, the mapping-scoring hot loop as a
    hand-written CUDA kernel for the no-bypass rows, with the oracle
    scoring the rest.  On a CPU device the kernel's plain PyTorch version
    (`kernels/mapspace_eval/ref.py`) takes the eligible rows instead —
    chosen by the device, never by what the host has.

``auto`` is ``cuda``.  The kernel's storage chains are the full memory
hierarchy, so only *no-bypass* mappings are eligible; a batch that mixes
bypass and no-bypass mappings is split, and the scores merged back in
order.

The kernel emits (cycles, energy, valid): it checks fanout and buffer
capacity per row in double, with the formulas `evaluate_batch` uses, so
both engines agree on the valid set exactly.  `validity_mask_arrays` is
the same check on the host, the reference the tests hold the kernel to.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

from ..device import as_device
from ..obs import current_tracer
from .batch_eval import (GOAL_KEY, HwStatic, batch_scores_arrays,
                         make_static, pack, tile_words_np)
from .mapping import Mapping

BACKENDS = ("auto", "torch", "cuda")


def resolve_backend(backend: str) -> str:
    """Validate and collapse `auto` to a concrete engine name."""
    if backend not in BACKENDS:
        raise ValueError(
            f"backend must be one of {BACKENDS}, got {backend!r}")
    return "cuda" if backend == "auto" else backend


def kernel_eligible(mapping: Mapping) -> bool:
    """The kernel assumes full storage chains: no tensor bypasses any
    memory level."""
    return all(not b for b in mapping.bypass)


def eligibility_mask(mappings) -> np.ndarray:
    """Per-row kernel eligibility for a Mapping sequence or a
    `PackedMapspace`."""
    from .mapspace_array import PackedMapspace
    if isinstance(mappings, PackedMapspace):
        return mappings.eligible
    return np.fromiter((kernel_eligible(m) for m in mappings), bool,
                       count=len(mappings))


def validity_mask_arrays(st: HwStatic, factors: np.ndarray,
                         store: np.ndarray) -> np.ndarray:
    """Fanout + buffer-capacity validity over packed arrays on the host,
    formula-identical to the checks in `evaluate_batch` and in the kernel."""
    f = np.asarray(factors, np.float64)
    store = np.asarray(store)
    B = f.shape[0]
    valid = np.ones((B,), bool)
    for ri, r in enumerate(st.rout_idx):
        valid &= f[:, r, :].prod(axis=1) <= st.fanout[ri]
    tile_at = np.flip(np.cumprod(np.flip(f, 1), axis=1), 1)
    for j, li in enumerate(st.mem_idx):
        if not math.isfinite(st.sizes[j]):
            continue
        words = tile_words_np(st, tile_at[:, li])       # [B, 3]
        used = np.where(store[:, j, :], words, 0.0).sum(axis=1)
        valid &= used <= st.sizes[j]
    return valid


def validity_mask(mappings: Sequence[Mapping]) -> np.ndarray:
    """Object-path wrapper over `validity_mask_arrays` (packs once)."""
    st = make_static(mappings[0].hardware, mappings[0].workload)
    factors, _, store = pack(mappings)
    return validity_mask_arrays(st, factors, store)


def _as_arrays(mappings):
    """Uniform array view of a batch: -> (st, factors, rank, store).
    Packs a Mapping sequence exactly once; a PackedMapspace passes
    through untouched."""
    from .mapspace_array import PackedMapspace
    if isinstance(mappings, PackedMapspace):
        return (mappings.static, mappings.factors, mappings.rank,
                mappings.store)
    st = make_static(mappings[0].hardware, mappings[0].workload)
    factors, rank, store = pack(mappings)
    return st, factors, rank, store


def goal_scores(cycles: np.ndarray, energy: np.ndarray,
                goal: str) -> np.ndarray:
    """Kernel outputs -> float64 goal scores (EDP as a float64 product)."""
    if goal == "latency":
        return np.asarray(cycles, np.float64)
    if goal == "energy":
        return np.asarray(energy, np.float64)
    return np.asarray(cycles, np.float64) * np.asarray(energy, np.float64)


def score_mapspace(mappings, goal: str = "edp", backend: str = "auto", *,
                   device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """-> (scores [n], valid [n]) numpy; lower score is better, invalid
    rows carry their score (mask with `valid` before argmin).

    `mappings` is a `Sequence[Mapping]` or a `PackedMapspace`; the batch
    is one mapspace (one hardware/workload pair).  `backend` is `auto`,
    `torch`, or `cuda`; the cuda engine scores the no-bypass rows with the
    kernel and the rest with the oracle.  Both run on `device`.
    """
    from ..kernels.mapspace_eval.ops import mapspace_eval_arrays
    from .mapspace_array import PackedMapspace
    if not isinstance(mappings, PackedMapspace):
        mappings = list(mappings)
    if len(mappings) == 0:
        raise ValueError("score_mapspace: empty mapping batch")
    if goal not in GOAL_KEY:
        raise ValueError(f"goal must be one of {sorted(GOAL_KEY)}, "
                         f"got {goal!r}")
    engine = resolve_backend(backend)
    dev = as_device(device)
    tr = current_tracer()
    st, factors, rank, store = _as_arrays(mappings)
    n = int(factors.shape[0])
    if engine == "torch":
        with tr.span("backend.torch", rows=n):
            scores, valid = batch_scores_arrays(st, factors, rank, store,
                                                goal, dev)
        tr.metrics.counter("backend.rows.torch").inc(n)
        return np.asarray(scores, np.float64), np.asarray(valid, bool)

    mask = eligibility_mask(mappings)
    n_kernel = int(mask.sum())
    scores = np.empty((n,), np.float64)
    valid = np.empty((n,), bool)
    with tr.span("backend.cuda", rows=n, kernel_rows=n_kernel,
                 torch_rows=n - n_kernel):
        if mask.any():
            idx = np.flatnonzero(mask)
            cycles, energy, valid[idx] = mapspace_eval_arrays(
                st, factors[idx], rank[idx], store[idx], device=dev)
            scores[idx] = goal_scores(cycles, energy, goal)
        if not mask.all():
            idx = np.flatnonzero(~mask)
            s, v = batch_scores_arrays(st, factors[idx], rank[idx],
                                       store[idx], goal, dev)
            scores[idx] = np.asarray(s, np.float64)
            valid[idx] = np.asarray(v, bool)
    tr.metrics.counter("backend.rows.kernel").inc(n_kernel)
    tr.metrics.counter("backend.rows.torch").inc(n - n_kernel)
    return scores, valid


def best_index(mappings, goal: str = "edp", backend: str = "auto", *,
               device="cuda") -> int:
    """Index of the goal-best *valid* mapping (ties break low)."""
    scores, valid = score_mapspace(mappings, goal, backend, device=device)
    return int(np.argmin(np.where(valid, scores, np.inf)))
