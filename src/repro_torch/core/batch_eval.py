"""Vectorized TRIM evaluator: score a *batch* of mappings as tensor code.

A mapspace is packed into integer tensors

    factors [B, L, 7]   loop bounds per tiling level per dim
    rank    [B, L, 7]   position of each dim in the level's loop order
                        (0 = outermost; irrelevant for routing levels)
    store   [B, Lm, 3]  which tensors each memory level stages (bypass)

and the whole evaluator (tile extents, buffer validity, delivery counts with
halo credit, psum read-modify-write, NoC classification, cycles, energy,
EDP) is closed-form batched float32 arithmetic, run eagerly on the device
of its inputs.  Semantics match `evaluator.evaluate_mapping`.

This is the plain oracle: it scores every row, bypass rows included.  The
no-bypass rows may instead go to the hand-written CUDA kernel
(`repro_torch.kernels.mapspace_eval`); callers pick an engine through
`core.backend.score_mapspace`.

Two front ends share one body:

  * `evaluate_batch(st, ...)` — one (architecture, workload) pair whose
    hardware constants are host scalars;
  * `evaluate_batch_multi(sig, params, ...)` — rows of any architectures
    sharing a structural `BatchSig`, with the constants as per-row tensors
    (`params_of`), so a cross-architecture round is one call.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..obs import current_tracer
from .designer import HardwareDesc
from .mapping import Mapping
from .workload import TENSORS, Workload, N_, M_, C_, R_, S_, E_, F_

COMPUTE_CHILD = -1


@dataclasses.dataclass(frozen=True)
class HwStatic:
    """Static (hashable) hardware + workload description for one mapspace."""
    n_levels: int
    mem_idx: Tuple[int, ...]            # tiling indices of memory levels
    rout_idx: Tuple[int, ...]
    sizes: Tuple[float, ...]            # per mem level (inf if unbounded)
    bandwidths: Tuple[float, ...]       # per mem level
    instances: Tuple[int, ...]          # per mem level
    read_e: Tuple[float, ...]
    write_e: Tuple[float, ...]
    leak: Tuple[float, ...]
    fanout: Tuple[int, ...]             # per routing level
    noc_bw: Tuple[float, ...]
    uni_e: Tuple[float, ...]
    multi_e: Tuple[float, ...]
    acc_e: Tuple[float, ...]
    num_pes: int
    macs_per_pe: int
    pipeline: int
    mac_e: float
    pe_leak: float
    zs_boundary: int                    # tiling idx or -1
    # workload
    dims: Tuple[int, ...]
    stride: Tuple[int, int]
    dilation: Tuple[int, int]
    depthwise: bool
    has_weight: bool
    in_zf: float
    w_zf: float


def make_static(hw: HardwareDesc, wl: Workload) -> HwStatic:
    mem = hw.memory_level_indices()
    rout = hw.routing_level_indices()
    lv = hw.tiling_levels
    zs = hw.zero_skip_boundary()
    return HwStatic(
        n_levels=len(lv), mem_idx=tuple(mem), rout_idx=tuple(rout),
        sizes=tuple(float(lv[i].size_words) if lv[i].size_words else
                    float("inf") for i in mem),
        bandwidths=tuple(lv[i].bandwidth for i in mem),
        instances=tuple(hw.instances(i) for i in mem),
        read_e=tuple(lv[i].read_energy for i in mem),
        write_e=tuple(lv[i].write_energy for i in mem),
        leak=tuple(lv[i].leak_power * hw.instances(i) for i in mem),
        fanout=tuple(lv[i].fanout for i in rout),
        noc_bw=tuple(lv[i].bandwidth for i in rout),
        uni_e=tuple(lv[i].unicast_energy for i in rout),
        multi_e=tuple(lv[i].multicast_energy for i in rout),
        acc_e=tuple(lv[i].accum_energy for i in rout),
        num_pes=hw.compute.num_pes, macs_per_pe=hw.compute.macs_per_pe,
        pipeline=hw.compute.pipeline, mac_e=hw.compute.mac_energy,
        pe_leak=hw.compute.pe_leak,
        zs_boundary=-1 if zs is None else zs,
        dims=tuple(wl.dims), stride=tuple(wl.stride),
        dilation=tuple(wl.dilation), depthwise=wl.depthwise,
        has_weight=wl.has_weight, in_zf=wl.input_zero_frac,
        w_zf=wl.weight_zero_frac)


def pack(mappings: Sequence[Mapping]):
    """Mapping objects -> (factors, rank, store) packed *host* arrays."""
    hw = mappings[0].hardware
    L = len(hw.tiling_levels)
    mem = hw.memory_level_indices()
    B = len(mappings)
    factors = np.ones((B, L, 7), np.int32)
    rank = np.zeros((B, L, 7), np.int32)
    store = np.ones((B, len(mem), 3), bool)
    for b, m in enumerate(mappings):
        for l in range(L):
            factors[b, l] = m.factors[l]
            order = m.orders[l]
            if order is not None:
                for pos, d in enumerate(order):
                    rank[b, l, d] = pos
        for j, li in enumerate(mem):
            for ti, t in enumerate(TENSORS):
                store[b, j, ti] = m.stores(li, t) or li == 0
    return factors, rank, store


RELEVANT = {
    "input": np.array([1, 0, 1, 1, 1, 1, 1], bool),
    "weight": np.array([0, 1, 1, 1, 1, 0, 0], bool),
    "output": np.array([1, 1, 0, 0, 0, 1, 1], bool),
}
SLIDING = np.zeros(7, bool)
SLIDING[[R_, S_, E_, F_]] = True

GOAL_KEY = {"latency": "cycles", "energy": "energy_pj", "edp": "edp"}


def tile_words_np(st: HwStatic, tile):
    """tile: [..., 7] float -> [..., 3] words in TENSORS order.  Numpy
    twin of `_tile_words`, shared by `core.backend.validity_mask_arrays`
    and `core.mapspace_array`."""
    n, m, c, r, s, e, f = (tile[..., i] for i in range(7))
    u, v = st.stride
    dr, ds = st.dilation
    p = (e - 1) * u + (r - 1) * dr + 1
    q = (f - 1) * v + (s - 1) * ds + 1
    w = (r * s * c * m) if st.has_weight else np.zeros_like(n)
    o = n * e * f * (c if st.depthwise else m)
    return np.stack([n * c * p * q, w, o], axis=-1)


# ---------------------------------------------------------------------------
# structural signature + per-row numerics (cross-architecture batches)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BatchSig:
    """Structural signature of an evaluation: everything the evaluator
    uses for control flow / tensor shapes, nothing it uses as a number."""
    n_levels: int
    mem_idx: Tuple[int, ...]
    rout_idx: Tuple[int, ...]
    depthwise: bool
    has_weight: bool


def sig_of(st: HwStatic) -> BatchSig:
    return BatchSig(n_levels=st.n_levels, mem_idx=st.mem_idx,
                    rout_idx=st.rout_idx, depthwise=st.depthwise,
                    has_weight=st.has_weight)


def params_of(st: HwStatic, n: int):
    """Numeric side of `st`, broadcast to [n, ...] arrays (one row per
    mapping) so fused batches can mix architectures and workloads."""
    rep = lambda v: np.broadcast_to(np.asarray(v, np.float32), (n,) +
                                    np.asarray(v, np.float32).shape).copy()
    return {
        "sizes": rep(st.sizes), "bandwidths": rep(st.bandwidths),
        "read_e": rep(st.read_e), "write_e": rep(st.write_e),
        "leak": rep(st.leak),
        "fanout": rep([float(f) for f in st.fanout]),
        "noc_bw": rep(st.noc_bw), "uni_e": rep(st.uni_e),
        "multi_e": rep(st.multi_e), "acc_e": rep(st.acc_e),
        "macs_per_pe": rep(float(st.macs_per_pe)),
        "pipeline": rep(float(st.pipeline)), "mac_e": rep(st.mac_e),
        "pe_leak_total": rep(st.pe_leak * st.num_pes),
        "zs_boundary": np.full((n,), st.zs_boundary, np.int32),
        "macs": rep(float(math.prod(st.dims))),
        "stride": rep([float(s) for s in st.stride]),
        "dilation": rep([float(d) for d in st.dilation]),
        "in_zf": rep(st.in_zf), "w_zf": rep(st.w_zf),
    }


# ---------------------------------------------------------------------------
# the evaluator body
# ---------------------------------------------------------------------------
def _tile_words(sig, k, tile) -> Dict[str, torch.Tensor]:
    """tile: [B, 7] -> dict tensor -> [B] words."""
    n, m, c, r, s, e, f = (tile[..., i] for i in range(7))
    (u, v), (dr, ds) = k["stride"], k["dilation"]
    p = (e - 1) * u + (r - 1) * dr + 1
    q = (f - 1) * v + (s - 1) * ds + 1
    return {
        "input": n * c * p * q,
        "weight": (r * s * c * m) if sig.has_weight else torch.zeros_like(n),
        "output": n * e * f * (c if sig.depthwise else m),
    }


def _fresh_input_words(k, tile, slide_dim):
    """Fresh input words for one slide step along slide_dim [B] int."""
    n, m, c, r, s, e, f = (tile[..., i] for i in range(7))
    (u, v), (dr, ds) = k["stride"], k["dilation"]
    p = (e - 1) * u + (r - 1) * dr + 1
    q = (f - 1) * v + (s - 1) * ds + 1
    fr_e = n * c * torch.minimum(p, e * u) * q
    fr_f = n * c * p * torch.minimum(q, f * v)
    fr_r = n * c * torch.minimum(p, r * dr) * q
    fr_s = n * c * p * torch.minimum(q, s * ds)
    return torch.where(slide_dim == E_, fr_e,
                       torch.where(slide_dim == F_, fr_f,
                                   torch.where(slide_dim == R_, fr_r, fr_s)))


def _evaluate(sig: BatchSig, k: dict, factors, rank, store):
    """Shared body of `evaluate_batch` and `evaluate_batch_multi`.  `k`
    holds the hardware/workload numerics, each either a host scalar
    (single pair) or a [B] tensor (per row) — the arithmetic broadcasts
    identically."""
    dev = factors.device
    B, L, _ = factors.shape
    f32 = factors.to(torch.float32)
    rank = rank.to(torch.int64)
    mem = list(sig.mem_idx)
    Lm = len(mem)
    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=dev)
    zeros = lambda: torch.zeros((B,), dtype=torch.float32, device=dev)

    # ---- tiles: tile_at[:, l] = prod_{l' >= l} factors -------------------
    tile_at = torch.flip(torch.cumprod(torch.flip(f32, (1,)), 1), (1,))
    tile_at = torch.cat([tile_at, ones(B, 1, 7)], 1)           # [B, L+1, 7]

    # ---- flattened temporal loop slots -----------------------------------
    # slot order: (memory level asc, rank within level asc)
    n_slots = Lm * 7
    slot_bound = ones(B, n_slots)
    slot_dim = torch.zeros((B, n_slots), dtype=torch.int64, device=dev)
    dim_ids = torch.arange(7, device=dev).expand(B, 7)
    for j, li in enumerate(mem):
        idx = j * 7 + rank[:, li, :]                           # [B, 7]
        slot_bound.scatter_(1, idx, f32[:, li, :])
        slot_dim.scatter_(1, idx, dim_ids)
    active = slot_bound > 1.0
    cum = torch.cumprod(slot_bound, 1)                         # [B, n_slots]

    rel_np = dict(RELEVANT)
    if sig.depthwise:
        rel_np["output"] = np.array([1, 1, 1, 0, 0, 1, 1], bool)
    rel_t = {t: torch.from_numpy(rel_np[t]).to(dev) for t in TENSORS}
    sliding = torch.from_numpy(SLIDING).to(dev)

    rout = list(sig.rout_idx)
    rout_prod = [torch.prod(f32[:, r, :], 1) for r in rout]     # [B] each

    def inst_before(tiling_idx):
        """Used instances outer than (data-dependent) tiling index [B]."""
        inst = ones(B)
        for ri, r in enumerate(rout):
            inst = inst * torch.where(tiling_idx > r, rout_prod[ri], 1.0)
        return inst

    def spatial_between(parent_tiling, child_tiling_static):
        """Per-dim routing factors with parent < r < child. [B, 7]."""
        S = ones(B, 7)
        for r in rout:
            if r < child_tiling_static:
                m = (parent_tiling < r)[:, None]
                S = S * torch.where(m, f32[:, r, :], 1.0)
        return S

    def scan_pair(child_j, tensor, parent_tiling):
        """Traffic for chain pair into child at mem position child_j
        (child_j == Lm means COMPUTE).  Returns dict of [B] tensors."""
        if child_j == Lm:
            per_inst = ones(B, 7)
            child_tiling = sig.n_levels
            n_vis = n_slots
        else:
            per_inst = tile_at[:, mem[child_j]]
            child_tiling = mem[child_j]
            n_vis = child_j * 7
        S = spatial_between(parent_tiling, child_tiling)
        union = per_inst * S
        pw = _tile_words(sig, k, per_inst)[tensor]
        uw = _tile_words(sig, k, union)[tensor]
        i_a = inst_before(parent_tiling)
        i_b = inst_before(torch.full((B,), child_tiling, device=dev))
        zero = zeros()
        if n_vis == 0:
            V = ones(B)
            D = V
            union_words = uw
        else:
            rel = rel_t[tensor][slot_dim[:, :n_vis]] & active[:, :n_vis]
            pos = torch.arange(1, n_vis + 1, device=dev)
            k1 = torch.where(rel, pos, 0).amax(1)              # 1-based
            has = k1 > 0
            kidx = torch.clamp(k1 - 1, min=0)[:, None]
            P_k = torch.gather(cum[:, :n_vis], 1, kidx)[:, 0]
            b_k = torch.gather(slot_bound[:, :n_vis], 1, kidx)[:, 0]
            d_k = torch.gather(slot_dim[:, :n_vis], 1, kidx)[:, 0]
            outer = P_k / b_k
            V = torch.where(has, P_k, 1.0)
            relb = rel & (pos[None, :] <= k1[:, None])
            D = torch.prod(torch.where(relb, slot_bound[:, :n_vis], 1.0), 1)
            D = torch.where(has, D, 1.0)
            union_words = V * uw
            if tensor == "input" and child_j != Lm:
                fresh = _fresh_input_words(k, union, d_k)
                slid = outer * (uw + (b_k - 1) * fresh)
                union_words = torch.where(has & sliding[d_k], slid,
                                          union_words)
        if tensor == "output":
            return {"parent_read": i_a * (V - D) * uw,
                    "parent_write": i_a * V * uw,
                    "child_read": zero if child_j == Lm else i_b * V * pw,
                    "child_write": zero if child_j == Lm
                    else i_b * (V - D) * pw,
                    "noc": i_b * (2 * V - D) * pw}
        return {"parent_read": i_a * union_words,
                "parent_write": zero,
                "child_read": zero,
                "child_write": zero if child_j == Lm else i_b * V * pw,
                "noc": i_a * union_words}

    # ---- chain pairs: reads/writes per memory level ----------------------
    reads = [zeros() for _ in range(Lm)]
    writes = [zeros() for _ in range(Lm)]
    raw = [zeros() for _ in range(Lm)]
    uni, multi, acc, noc_raw = zeros(), zeros(), zeros(), zeros()
    spatial = [f32[:, r, :] for r in rout]                     # [B,7] each
    m_w = [(s[:, [N_, E_, F_]] > 1).any(1) for s in spatial]
    m_i = [s[:, M_] > 1 for s in spatial]
    a_o = [(s[:, [C_, R_, S_]] > 1).any(1) for s in spatial]
    mem_t = torch.tensor(mem, device=dev)
    zs_b = torch.as_tensor(k["zs_boundary"], device=dev)
    zf = k["zf"]

    tensors = ["input", "output"] + (["weight"] if sig.has_weight else [])
    for ti, tensor in enumerate(TENSORS):
        if tensor not in tensors:
            continue
        st_flag = store[:, :, ti]                              # [B, Lm]
        for child_j in list(range(1, Lm)) + [Lm]:
            if child_j < Lm:
                stores_child = st_flag[:, child_j]
            else:
                stores_child = torch.ones((B,), dtype=torch.bool, device=dev)
            # parent = largest storing mem position < child_j
            cand = st_flag[:, :child_j]
            ppos = torch.where(cand, torch.arange(child_j, device=dev),
                               0).amax(1)                      # [B]
            parent_tiling = mem_t[ppos]
            stats = scan_pair(child_j, tensor, parent_tiling)
            zs_f = torch.where(
                (zs_b >= 0) & (parent_tiling >= zs_b)
                & (tensor != "output"), zf[tensor], 1.0)
            gate0 = stores_child.to(torch.float32)
            gate = gate0 * zs_f
            for j in range(Lm):
                sel = (ppos == j).to(torch.float32)
                reads[j] = reads[j] + sel * gate * stats["parent_read"]
                writes[j] = writes[j] + sel * gate * stats["parent_write"]
                raw[j] = raw[j] + sel * gate0 * (stats["parent_read"]
                                                 + stats["parent_write"])
            if child_j < Lm:
                writes[child_j] = writes[child_j] \
                    + gate * stats["child_write"]
                reads[child_j] = reads[child_j] + gate * stats["child_read"]
                raw[child_j] = raw[child_j] + gate0 * (
                    stats["child_write"] + stats["child_read"])
            # routing crossings: parent_tiling < r < child_tiling
            child_tiling = (mem[child_j] if child_j < Lm else sig.n_levels)
            w = gate * stats["noc"]
            w_raw = gate0 * stats["noc"]
            for ri, r in enumerate(rout):
                crosses = (parent_tiling < r) & (r < child_tiling)
                wc = torch.where(crosses, w, 0.0)
                noc_raw = noc_raw + torch.where(crosses, w_raw, 0.0)
                if tensor == "weight":
                    uni = uni + torch.where(m_w[ri], 0.0, wc)
                    multi = multi + torch.where(m_w[ri], wc, 0.0)
                elif tensor == "input":
                    uni = uni + torch.where(m_i[ri], 0.0, wc)
                    multi = multi + torch.where(m_i[ri], wc, 0.0)
                else:
                    uni = uni + torch.where(a_o[ri], 0.0, wc)
                    acc = acc + torch.where(a_o[ri], wc, 0.0)

    # ---- cycles / energy ---------------------------------------------------
    pes_used = torch.prod(torch.stack([torch.prod(s, 1) for s in spatial]),
                          0) if spatial else ones(B)
    cycles = k["macs"] / (torch.clamp(pes_used, min=1.0)
                          * k["macs_per_pe"] * k["pipeline"])
    dyn = k["dyn0"]
    leak_rate = k["pe_leak_total"]
    for j in range(Lm):
        inst_j = inst_before(torch.full((B,), mem[j], device=dev))
        cycles = torch.maximum(cycles,
                               raw[j] / (k["bandwidths"][j] * inst_j))
        dyn = dyn + reads[j] * k["read_e"][j] + writes[j] * k["write_e"][j]
        leak_rate = leak_rate + k["leak"][j]
    for ri in range(len(rout)):
        cycles = torch.maximum(cycles, noc_raw / k["noc_bw"][ri])
        dyn = dyn + (uni * k["uni_e"][ri] + multi * k["multi_e"][ri]
                     + acc * k["acc_e"][ri])
    static = leak_rate * cycles
    energy = dyn + static

    # ---- validity ----------------------------------------------------------
    valid = torch.ones((B,), dtype=torch.bool, device=dev)
    for ri, r in enumerate(rout):
        valid &= torch.prod(f32[:, r, :], 1) <= k["fanout"][ri]
    for j, li in enumerate(mem):
        size = k["sizes"][j]
        if isinstance(size, float) and not math.isfinite(size):
            continue
        tw = _tile_words(sig, k, tile_at[:, li])
        used = zeros()
        for ti, t in enumerate(TENSORS):
            used = used + torch.where(store[:, j, ti], tw[t], 0.0)
        valid &= used <= size

    return {"cycles": cycles, "dynamic_pj": dyn, "static_pj": static,
            "energy_pj": energy, "edp": cycles * energy, "valid": valid,
            "pes_used": pes_used}


def evaluate_batch(st: HwStatic, factors, rank, store):
    """One (architecture, workload) pair; tensors on any device.
    -> dict of [B] tensors: cycles, dynamic_pj, static_pj, energy_pj, edp,
    valid, pes_used."""
    B = factors.shape[0]
    zf = {"input": 1.0 - st.in_zf,
          "weight": 1.0 - (st.w_zf if st.has_weight else 0.0),
          "output": 1.0}
    macs = float(math.prod(st.dims))
    dyn0 = (macs * zf["input"] * zf["weight"] * st.mac_e
            if st.zs_boundary >= 0 else macs * st.mac_e)
    k = dict(stride=st.stride, dilation=st.dilation,
             zs_boundary=st.zs_boundary, zf=zf, macs=macs,
             macs_per_pe=st.macs_per_pe, pipeline=st.pipeline,
             dyn0=torch.full((B,), dyn0, dtype=torch.float32,
                             device=factors.device),
             pe_leak_total=st.pe_leak * st.num_pes,
             sizes=st.sizes, bandwidths=st.bandwidths, read_e=st.read_e,
             write_e=st.write_e, leak=st.leak, fanout=st.fanout,
             noc_bw=st.noc_bw, uni_e=st.uni_e, multi_e=st.multi_e,
             acc_e=st.acc_e)
    return _evaluate(sig_of(st), k, factors, rank, store)


def evaluate_batch_multi(sig: BatchSig, params, factors, rank, store):
    """`evaluate_batch` with per-mapping hardware/workload constants
    (`params`: the `params_of` dict as tensors on the device of `factors`);
    rows may mix any architectures/workloads that share `sig`."""
    p = {name: v.to(torch.float32) for name, v in params.items()
         if name != "zs_boundary"}
    cols = lambda a: [a[:, i] for i in range(a.shape[1])]
    one = torch.ones_like(p["macs"])
    zf = {"input": 1.0 - p["in_zf"],
          "weight": (1.0 - p["w_zf"]) if sig.has_weight else one,
          "output": one}
    zs_b = params["zs_boundary"]
    k = dict(stride=cols(p["stride"]), dilation=cols(p["dilation"]),
             zs_boundary=zs_b, zf=zf, macs=p["macs"],
             macs_per_pe=p["macs_per_pe"], pipeline=p["pipeline"],
             dyn0=p["macs"] * torch.where(zs_b >= 0,
                                          zf["input"] * zf["weight"], 1.0)
             * p["mac_e"],
             pe_leak_total=p["pe_leak_total"])
    for name in ("sizes", "bandwidths", "read_e", "write_e", "leak",
                 "fanout", "noc_bw", "uni_e", "multi_e", "acc_e"):
        k[name] = cols(p[name])
    return _evaluate(sig, k, factors, rank, store)


def note_batch_dispatch(rows: int) -> None:
    """Count one oracle dispatch (and its rows) into the ambient tracer's
    metrics."""
    m = current_tracer().metrics
    m.counter("batch_eval.dispatches").inc()
    m.histogram("batch_eval.rows").observe(float(rows))


def batch_scores_arrays(st: HwStatic, factors, rank, store,
                        goal: str = "edp", device="cuda"):
    """Score pre-packed host arrays with one `evaluate_batch` call on
    `device` -> (scores [n], valid [n]) numpy."""
    from ..device import as_device, to_device
    dev = as_device(device)
    n = int(factors.shape[0])
    note_batch_dispatch(n)
    # the copy back waits for the device: bracket it in a span so device
    # time is attributable even when no caller holds one open
    with current_tracer().span("batch_eval.scores", rows=n):
        out = evaluate_batch(st, to_device(factors, dev),
                             to_device(rank, dev), to_device(store, dev))
        return (out[GOAL_KEY[goal]].cpu().numpy(),
                out["valid"].cpu().numpy())


def batch_scores(mappings, goal: str = "edp", device="cuda"):
    """Score a mapspace (a `Sequence[Mapping]` — packed here exactly once
    — or a pre-packed `core.mapspace_array.PackedMapspace`) with the
    oracle on `device` -> (scores [n], valid [n]) numpy."""
    from .mapspace_array import PackedMapspace
    if isinstance(mappings, PackedMapspace):
        return batch_scores_arrays(mappings.static, mappings.factors,
                                   mappings.rank, mappings.store, goal,
                                   device)
    st = make_static(mappings[0].hardware, mappings[0].workload)
    factors, rank, store = pack(mappings)
    return batch_scores_arrays(st, factors, rank, store, goal, device)


def batch_best_index(mappings, goal: str = "edp", backend: str = "torch",
                     device="cuda") -> int:
    """Index of the goal-best valid mapping (ties break low); `mappings`
    is a Mapping sequence or a `PackedMapspace`.  `backend="torch"` is
    this module's oracle; any other engine goes through
    `core.backend.best_index`."""
    if backend != "torch":
        from .backend import best_index     # lazy: backend wraps this module
        return best_index(mappings, goal, backend, device=device)
    scores, valid = batch_scores(mappings, goal, device)
    return int(np.argmin(np.where(valid, scores, np.inf)))


# ---------------------------------------------------------------------------
# Multi-device sharding.  Every output row of a fused group depends only on
# its own factors/rank/store/params row, so a large group splits along the
# mapping axis into one contiguous shard per device and the host merge
# concatenates the per-shard results: bit-identical to the one-call path.
# ---------------------------------------------------------------------------
SHARD_MIN_ROWS = 4096   # below this, sharding overhead beats the win


def shard_bounds(n: int, k: int,
                 min_rows: int = SHARD_MIN_ROWS) -> List[Tuple[int, int]]:
    """Split `n` rows into at most `k` contiguous (lo, hi) shards of
    near-equal size, never creating a shard smaller than `min_rows`
    (small groups stay whole — per-device dispatch overhead would
    dominate).  Always returns at least one shard covering [0, n)."""
    if n <= 0:
        return [(0, max(n, 0))]
    k = max(1, min(k, n // max(1, min_rows)))
    if k <= 1:
        return [(0, n)]
    base, extra = divmod(n, k)
    bounds: List[Tuple[int, int]] = []
    lo = 0
    for i in range(k):
        hi = lo + base + (1 if i < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def score_devices(device="cuda") -> Tuple[torch.device, ...]:
    """Devices the fused scorer may shard a group over: every CUDA device
    of the host (`cuda:0` ... `cuda:{n-1}`) for a CUDA `device`, else the
    one CPU device."""
    from ..device import as_device
    dev = as_device(device)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)
