"""Cross-architecture batched mapspace evaluation.

Scoring one (architecture, workload) pair per call pays per-call launch
and copy overhead dozens of times over in a DSE round.  Here all pending
(arch, workload) mapspaces of a round are grouped by their structural
`BatchSig` — identical level layout / tensor set, the only things the
fused evaluator needs fixed — and each group is scored by one
`evaluate_batch_multi` call with per-mapping hardware constants.  Every
architecture from one Designer template shares one signature, so a whole
round fuses into one call per workload *shape family*.

Under the `cuda` engine, jobs whose whole mapspace is kernel-eligible (no
bypass) go instead to the multi-architecture CUDA kernel, one launch per
BatchSig group (`_kernel_group`).

Jobs carry either a `core.mapspace_array.PackedMapspace` (array-native —
zero packing happens here) or a `Mapping` list (packed exactly once, then
treated identically).

For the streaming driver (`search.driver`, overlap mode), `fused_launch`
enqueues every oracle group on the device and returns its scores as
device tensors, not yet copied back (`@obs.deferred_sync`), so the host
can build the next round while the device scores this one;
`fused_collect` copies them back and takes the argmin (the driver's
"device-wait" phase).  Kernel groups resolve inside `fused_launch`.
`fused_best` is the synchronous form with identical winners.
`fused_collect` must run in the thread that called `fused_launch`: the
scores were enqueued on that thread's current stream.

Shard plan: rows of a fused group are independent, so a large oracle group
splits along the mapping axis into one contiguous shard per device of
`core.batch_eval.score_devices` (`_shard_plan`), each shard's tensors on
its own device, and `_merge_shards` copies them back and concatenates them
in row order — bit-identical to the unsharded call.  A kernel group splits
into whole jobs (`_kernel_shard_plan`), each sub-group launched on its
device.  On one card the plan is one unpinned entry: the scoring device
the caller gave.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.backend import eligibility_mask, goal_scores, resolve_backend
from ..core.batch_eval import (GOAL_KEY, SHARD_MIN_ROWS,
                               evaluate_batch_multi, make_static,
                               note_batch_dispatch, pack, params_of,
                               score_devices, shard_bounds, sig_of)
from ..core.designer import HardwareDesc
from ..core.mapping import Mapping
from ..core.workload import Workload
from ..device import as_device, on_device, to_device
from ..obs import current_tracer, deferred_sync


@dataclasses.dataclass
class MapspaceJob:
    """One pending mapspace search: pick the goal-best mapping of the
    job's mapspace (all on the same hw/workload).  Provide either
    `mappings` (objects) or `packed` (array-native)."""
    tag: object                       # caller identity, returned with result
    hw: HardwareDesc
    workload: Workload
    mappings: Optional[List[Mapping]] = None
    packed: Optional["object"] = None           # PackedMapspace

    def n_rows(self) -> int:
        if self.packed is not None:
            return len(self.packed)
        return len(self.mappings or [])


@dataclasses.dataclass
class JobBest:
    tag: object
    index: int                        # argmin into the job's mapspace
    value: float                      # goal score of the winner
    n_scored: int


@dataclasses.dataclass
class _JobArrays:
    """Packed view of one job (computed at most once per job)."""
    st: object                        # HwStatic
    factors: np.ndarray
    rank: np.ndarray
    store: np.ndarray
    eligible: np.ndarray


def _job_arrays(job: MapspaceJob) -> _JobArrays:
    if job.packed is not None:
        p = job.packed
        return _JobArrays(p.static, p.factors, p.rank, p.store, p.eligible)
    st = make_static(job.hw, job.workload)
    factors, rank, store = pack(job.mappings)
    return _JobArrays(st, factors, rank, store,
                      eligibility_mask(job.mappings))


def _chunk(idxs: List[int], sizes: Dict[int, int],
           max_group: int) -> List[List[int]]:
    """Split a job-index group so no chunk exceeds `max_group` rows."""
    chunks: List[List[int]] = [[]]
    rows = 0
    for i in idxs:
        n = sizes[i]
        if chunks[-1] and rows + n > max_group:
            chunks.append([])
            rows = 0
        chunks[-1].append(i)
        rows += n
    return chunks


def _group_jobs(jobs: Sequence[MapspaceJob], engine: str):
    """Group job indices by BatchSig; under the cuda engine, jobs whose
    rows are all kernel-eligible form separate kernel groups."""
    groups: Dict[object, List[int]] = {}
    kernel_groups: Dict[object, List[int]] = {}
    arrays: List[_JobArrays] = []
    sizes: Dict[int, int] = {}
    for i, job in enumerate(jobs):
        if not job.n_rows():
            raise ValueError(f"job {job.tag!r}: empty mapspace")
        a = _job_arrays(job)
        arrays.append(a)
        sizes[i] = a.factors.shape[0]
        if engine == "cuda" and a.eligible.all():
            kernel_groups.setdefault(sig_of(a.st), []).append(i)
        else:
            groups.setdefault(sig_of(a.st), []).append(i)
    return groups, kernel_groups, arrays, sizes


def _assign_best(idxs: List[int], counts: List[int], jobs, scores,
                 out: List[Optional[JobBest]]) -> None:
    """Per-job argmin over the group's merged score vector (+inf rows
    already applied): ties break to the lowest index."""
    off = 0
    for i, cnt in zip(idxs, counts):
        seg = scores[off: off + cnt]
        best = int(np.argmin(seg))
        out[i] = JobBest(tag=jobs[i].tag, index=best,
                         value=float(seg[best]), n_scored=cnt)
        off += cnt


def _each_chunk(todo: Dict[object, List[int]], sizes: Dict[int, int],
                max_group: int):
    """-> (sig, chunk, rows) for every `max_group`-bounded chunk of every
    BatchSig group in `todo`."""
    for sig, idxs in todo.items():
        for chunk in _chunk(idxs, sizes, max_group):
            yield sig, chunk, sum(sizes[i] for i in chunk)


def _observe_chunk(tr, chunk: List[int], rows: int) -> None:
    tr.metrics.histogram("fused.group_rows").observe(rows)
    tr.metrics.histogram("fused.group_jobs").observe(len(chunk))


def _kernel_groups(kernel_groups, sizes, max_group, jobs, arrays, goal,
                   out, dev, tr) -> None:
    """Score every kernel group now, one launch per chunk."""
    for sig, chunk, rows in _each_chunk(kernel_groups, sizes, max_group):
        with tr.span("fused.kernel-group", jobs=len(chunk), rows=rows):
            _kernel_group(chunk, jobs, arrays, goal, out, dev)
        _observe_chunk(tr, chunk, rows)


def fused_best(jobs: Sequence[MapspaceJob], goal: str = "edp",
               max_group: int = 65536, *, device="cuda",
               backend: str = "auto") -> List[JobBest]:
    """Goal-best mapping index per job, fusing jobs across architectures.

    Jobs are grouped by BatchSig; each group is scored by one
    `evaluate_batch_multi` call (split if it would exceed `max_group`
    rows).  Invalid mappings score +inf and ties break to the lowest
    index.  Under the `cuda` engine (`auto`), jobs whose whole mapspace is
    kernel-eligible are scored per BatchSig group by ONE
    multi-architecture kernel launch instead; the remaining jobs keep the
    fused oracle path.
    """
    engine = resolve_backend(backend)
    dev = as_device(device)
    groups, kernel_groups, arrays, sizes = _group_jobs(jobs, engine)
    out: List[Optional[JobBest]] = [None] * len(jobs)
    tr = current_tracer()
    _kernel_groups(kernel_groups, sizes, max_group, jobs, arrays, goal, out,
                   dev, tr)
    for sig, chunk, rows in _each_chunk(groups, sizes, max_group):
        with tr.span("fused.torch-group", jobs=len(chunk), rows=rows):
            _eval_group(sig, chunk, jobs, arrays, goal, out, dev)
        _observe_chunk(tr, chunk, rows)
    return [b for b in out if b is not None]


@dataclasses.dataclass
class _PendingGroup:
    """One oracle chunk whose scores are still on the device(s)."""
    idxs: List[int]
    counts: List[int]
    pend: List[Tuple[object, object]]   # per shard: (scores, valid) tensors


@dataclasses.dataclass
class PendingFused:
    """In-flight fused round: kernel-group winners already resolved in
    `out`; oracle groups awaiting their copy back in `fused_collect`,
    which must run in the launching thread (`thread`)."""
    jobs: Sequence[MapspaceJob]
    groups: List[_PendingGroup]
    out: List[Optional[JobBest]]
    thread: int = dataclasses.field(default_factory=threading.get_ident)


@deferred_sync
def fused_launch(jobs: Sequence[MapspaceJob], goal: str = "edp",
                 max_group: int = 65536, *, device="cuda",
                 backend: str = "auto") -> PendingFused:
    """Enqueue every fused scoring call of a round and return without
    waiting for the oracle groups.

    Grouping, chunking and selection are exactly `fused_best`'s —
    `fused_collect(fused_launch(jobs))` gives the same winners — but the
    oracle groups come back as device tensors so the caller can overlap
    host work with device execution.  Kernel groups resolve here: their
    op copies its outputs back, which keeps their device time inside the
    launching span.
    """
    engine = resolve_backend(backend)
    dev = as_device(device)
    groups, kernel_groups, arrays, sizes = _group_jobs(jobs, engine)
    out: List[Optional[JobBest]] = [None] * len(jobs)
    tr = current_tracer()
    _kernel_groups(kernel_groups, sizes, max_group, jobs, arrays, goal, out,
                   dev, tr)
    pending: List[_PendingGroup] = []
    for sig, chunk, rows in _each_chunk(groups, sizes, max_group):
        with tr.span("fused.torch-dispatch", jobs=len(chunk), rows=rows):
            pending.append(_launch_group(sig, chunk, arrays, goal, dev))
        _observe_chunk(tr, chunk, rows)
    return PendingFused(jobs=jobs, groups=pending, out=out)


def fused_collect(pending: PendingFused) -> List[JobBest]:
    """Copy a `fused_launch` round's oracle scores back and resolve the
    per-job winners.  Callers bracket this in the span that owns the
    device time (the streaming driver's "device-wait" phase)."""
    if threading.get_ident() != pending.thread:
        raise RuntimeError("fused_collect must run in the thread that "
                           "called fused_launch (its scores are on that "
                           "thread's current stream)")
    for g in pending.groups:
        _collect_group(g, pending.jobs, pending.out)
    return [b for b in pending.out if b is not None]


def _local_devices(device) -> tuple:
    return score_devices(device)


def _shard_plan(n: int, devices) -> List[Tuple[Tuple[int, int],
                                               Optional[torch.device]]]:
    """-> [((lo, hi), device), ...] covering [0, n).  A single entry with
    device None (the caller's scoring device, unpinned) unless more than
    one device is available and the group is big enough that every shard
    clears `SHARD_MIN_ROWS`."""
    if len(devices) <= 1 or n < 2 * SHARD_MIN_ROWS:
        return [((0, n), None)]
    bounds = shard_bounds(n, len(devices))
    if len(bounds) <= 1:
        return [((0, n), None)]
    return [(b, devices[i % len(devices)]) for i, b in enumerate(bounds)]


def _kernel_shard_plan(idxs: List[int], counts: List[int],
                       devices) -> List[Tuple[List[int],
                                              Optional[torch.device]]]:
    """Partition a kernel group's *jobs* (kept whole — each is one job
    record of the launch) into contiguous per-device sub-lists of
    near-equal row weight.  One (all jobs, None) entry on a single-device
    host or when the group is too small to shard."""
    total = sum(counts)
    if len(devices) <= 1 or len(idxs) <= 1 or total < 2 * SHARD_MIN_ROWS:
        return [(list(idxs), None)]
    n_shards = min(len(devices), len(idxs), total // SHARD_MIN_ROWS)
    if n_shards <= 1:
        return [(list(idxs), None)]
    target = total / n_shards
    plan: List[Tuple[List[int], Optional[torch.device]]] = []
    cur: List[int] = []
    acc = 0.0
    for i, cnt in zip(idxs, counts):
        cur.append(i)
        acc += cnt
        if acc >= target and len(plan) < n_shards - 1:
            plan.append((cur, devices[len(plan) % len(devices)]))
            cur, acc = [], 0.0
    if cur:
        plan.append((cur, devices[len(plan) % len(devices)]))
    return plan


def _kernel_group(idxs: List[int], jobs, arrays: List[_JobArrays],
                  goal: str, out: List[Optional[JobBest]], dev) -> None:
    """Score one BatchSig group of kernel-eligible jobs, validity
    included, with one multi-architecture kernel launch per shard of
    `_kernel_shard_plan` (one launch on one card)."""
    from ..kernels.mapspace_eval.ops import mapspace_eval_multi
    counts = [arrays[i].factors.shape[0] for i in idxs]
    parts = []
    for sub, shard_dev in _kernel_shard_plan(idxs, counts,
                                             _local_devices(dev)):
        d = dev if shard_dev is None else shard_dev
        with on_device(d):
            parts.append(mapspace_eval_multi(
                [(arrays[i].st, arrays[i].factors, arrays[i].rank,
                  arrays[i].store) for i in sub], device=d))
    cycles, energy, valid = (np.concatenate(p) for p in zip(*parts))
    scores = goal_scores(cycles, energy, goal)
    _assign_best(idxs, counts, jobs, np.where(valid, scores, np.inf), out)


_ROW_ARRAYS = ("factors", "rank", "store")


def _group_arrays(idxs: List[int], arrays: List[_JobArrays]):
    """One chunk's per-job pieces: -> (row counts, {name: [per-job
    array]}) for the packed arrays and every per-row hw param."""
    counts = [arrays[i].factors.shape[0] for i in idxs]
    per_job = [params_of(arrays[i].st, n) for i, n in zip(idxs, counts)]
    pieces = {name: [getattr(arrays[i], name) for i in idxs]
              for name in _ROW_ARRAYS}
    pieces.update({name: [p[name] for p in per_job]
                   for name in per_job[0]})
    return counts, pieces


def _rows(pieces: List[np.ndarray], lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) of the concatenation of `pieces`, built from the
    pieces that overlap them only."""
    out, off = [], 0
    for a in pieces:
        n = a.shape[0]
        if off < hi and off + n > lo:
            out.append(a[max(lo - off, 0):min(hi - off, n)])
        off += n
    return np.concatenate(out)


@deferred_sync
def _dispatch_shards(sig, key: str, pieces, plan,
                     dev) -> List[Tuple[object, object]]:
    """Enqueue one `evaluate_batch_multi` call per shard of `plan`, each
    shard's tensors on its own device (None: `dev`) -> per shard the
    (scores, valid) tensors, still on the device.  Each host array is
    assembled just before its copy and dropped after it (holding a whole
    group's ~24 MB of host arrays until the call measured slower on the
    H100's host)."""
    pend = []
    for (lo, hi), shard_dev in plan:
        d = dev if shard_dev is None else shard_dev
        note_batch_dispatch(hi - lo)
        t = {name: to_device(_rows(p, lo, hi), d)
             for name, p in pieces.items()}
        row_arrays = [t.pop(name) for name in _ROW_ARRAYS]
        res = evaluate_batch_multi(sig, t, *row_arrays)
        pend.append((res[key], res["valid"]))
    return pend


def _merge_shards(pend):
    """Copy per-shard results back and concatenate them in row order ->
    (scores, valid) numpy."""
    scores = np.concatenate([s.cpu().numpy() for s, _ in pend])
    valid = np.concatenate([v.cpu().numpy() for _, v in pend])
    return scores, valid


def _launch_group(sig, idxs: List[int], arrays: List[_JobArrays],
                  goal: str, dev) -> _PendingGroup:
    """Enqueue one BatchSig group's oracle call(s) on the shard plan's
    devices; the scores stay there."""
    counts, pieces = _group_arrays(idxs, arrays)
    plan = _shard_plan(sum(counts), _local_devices(dev))
    return _PendingGroup(idxs=idxs, counts=counts, pend=_dispatch_shards(
        sig, GOAL_KEY[goal], pieces, plan, dev))


def _collect_group(g: _PendingGroup, jobs,
                   out: List[Optional[JobBest]]) -> None:
    """Copy one group's scores back and assign its jobs' winners."""
    scores, valid = _merge_shards(g.pend)
    _assign_best(g.idxs, g.counts, jobs, np.where(valid, scores, np.inf),
                 out)


def _eval_group(sig, idxs: List[int], jobs, arrays: List[_JobArrays],
                goal: str, out: List[Optional[JobBest]], dev) -> None:
    """Score one BatchSig group now: one call, or a sharded dispatch and
    host merge when the plan has several shards."""
    counts, pieces = _group_arrays(idxs, arrays)
    plan = _shard_plan(sum(counts), _local_devices(dev))
    key = GOAL_KEY[goal]
    if len(plan) > 1:
        scores, valid = _eval_group_sharded(sig, key, pieces, plan, dev)
    else:
        scores, valid = _merge_shards(_dispatch_shards(sig, key, pieces,
                                                       plan, dev))
    _assign_best(idxs, counts, jobs, np.where(valid, scores, np.inf), out)


def _eval_group_sharded(sig, key: str, pieces, plan, dev):
    """Multi-device dispatch + host merge for one fused group; the result
    is bit-identical to the one-call path because the evaluator is
    row-wise."""
    tr = current_tracer()
    with tr.span("fused.shard-dispatch", shards=len(plan)):
        pend = _dispatch_shards(sig, key, pieces, plan, dev)
    with tr.span("fused.shard-merge", shards=len(pend)):
        return _merge_shards(pend)


def per_arch_best(jobs: Sequence[MapspaceJob], goal: str = "edp",
                  use_batch: bool = True, *, device="cuda",
                  backend: str = "auto") -> List[JobBest]:
    """One `best_index` (or, below 64 rows or without `use_batch`, a
    scalar loop over the evaluator) per job — the explorer's per-workload
    selection.  An engine that fails raises: nothing falls back to the
    scalar loop."""
    from ..core.backend import best_index
    from ..core.evaluator import evaluate_mapping
    from ..core.explorer import GOALS

    resolve_backend(backend)
    dev = as_device(device)
    tr = current_tracer()
    score = GOALS[goal]
    out: List[JobBest] = []
    for job in jobs:
        with tr.span("per-arch.job", rows=job.n_rows()):
            batch = job.packed if job.packed is not None else job.mappings
            mat = (job.packed.materialize if job.packed is not None
                   else job.mappings.__getitem__)
            if use_batch and job.n_rows() >= 64:
                best_i = best_index(batch, goal, backend, device=dev)
                best_v = score(evaluate_mapping(mat(best_i)))
            else:
                best_v = math.inf
                best_i = 0
                for i in range(job.n_rows()):
                    v = score(evaluate_mapping(mat(i)))
                    if v < best_v:
                        best_i, best_v = i, v
            out.append(JobBest(tag=job.tag, index=best_i, value=best_v,
                               n_scored=job.n_rows()))
    return out
