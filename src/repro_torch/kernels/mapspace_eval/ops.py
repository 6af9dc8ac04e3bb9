"""Packed mapspace arrays -> kernel tensors -> scores.

Precomputes the per-mapping tensors described in kernel.py (numpy, on the
host) from packed `(factors, rank)` arrays, copies them to the device (one
`torch.from_numpy(...).to(device)` per array), launches, and copies the
scores back.  Two entry points:

  * `mapspace_eval_arrays(st, f, r, device=...)` — one hardware/workload
    pair, constants passed to the single-arch kernel by value;
  * `mapspace_eval_multi(groups, device=...)` — rows from several
    `(HwStatic, factors, rank)` groups sharing one `BatchSig` fuse into ONE
    launch with per-row hardware constants (the
    `core.batch_eval.evaluate_batch_multi` contract).

Only no-bypass mappings are accepted (the kernel's storage chains are the
full memory hierarchy); the general path is core.batch_eval, and
`core.backend.score_mapspace` splits a mapspace between the two.

Spans (ambient tracer): `kernel.pack` (host packer), `kernel.h2d`,
`kernel.run` (launch; synchronised only while a tracer records, so the
split is honest) and `kernel.d2h`.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ...core.batch_eval import (RELEVANT, SLIDING, HwStatic, sig_of,
                                tile_words_np as _tile_words_np)
from ...core.workload import N_, M_, C_, R_, S_, E_, F_
from ...device import as_device, to_device
from ...obs import current_tracer
from .kernel import mapspace_eval_fwd, mapspace_eval_multi_fwd


def _fresh_np(st: HwStatic, tile, d):
    n, m, c, r, s, e, f = (tile[..., i] for i in range(7))
    u, v = st.stride
    dr, ds = st.dilation
    p = (e - 1) * u + (r - 1) * dr + 1
    q = (f - 1) * v + (s - 1) * ds + 1
    if d == E_:
        return n * c * np.minimum(p, e * u) * q
    if d == F_:
        return n * c * p * np.minimum(q, f * v)
    if d == R_:
        return n * c * np.minimum(p, r * dr) * q
    return n * c * p * np.minimum(q, s * ds)


def _mapping_rows(st: HwStatic, factors: np.ndarray, rank: np.ndarray):
    """The twelve per-mapping kernel arrays (numpy) for one hardware/
    workload pair.  Shared by the single-arch packer (constants by value)
    and the multi-arch packer (constants as per-row arrays)."""
    factors = np.asarray(factors, np.float32)
    rank = np.asarray(rank)
    B, L, _ = factors.shape
    mem = list(st.mem_idx)
    rout = list(st.rout_idx)
    Lm = len(mem)
    S = Lm * 7

    tile_at = np.flip(np.cumprod(np.flip(factors, 1), axis=1), 1)
    tile_at = np.concatenate([tile_at, np.ones((B, 1, 7), np.float32)], 1)

    slot_bound = np.ones((B, S), np.float32)
    slot_dim = np.zeros((B, S), np.int64)
    for j, li in enumerate(mem):
        for d in range(7):
            idx = j * 7 + rank[:, li, d]
            slot_bound[np.arange(B), idx] = factors[:, li, d]
            slot_dim[np.arange(B), idx] = d
    cum = np.cumprod(slot_bound, axis=1)

    rel_i = RELEVANT["input"][slot_dim].astype(np.float32)
    rel_w = RELEVANT["weight"][slot_dim].astype(np.float32)
    rel_out = RELEVANT["output"].copy()
    if st.depthwise:
        rel_out = np.array([1, 1, 1, 0, 0, 1, 1], bool)
    rel_o = rel_out[slot_dim].astype(np.float32)

    def inst_before(tiling_idx):
        inst = np.ones((B,), np.float32)
        for r in rout:
            if r < tiling_idx:
                inst *= np.prod(factors[:, r, :], axis=1)
        return inst

    L1 = Lm  # children: mem[1..Lm-1] + compute
    tw_u = np.zeros((B, L1, 3), np.float32)
    tw_p = np.zeros((B, L1, 3), np.float32)
    fresh = np.zeros((B, L1, S), np.float32)
    ia = np.zeros((B, L1), np.float32)
    ib = np.zeros((B, L1), np.float32)
    noc_e = np.zeros((B, L1, 3), np.float32)
    noc_m = np.zeros((B, L1), np.float32)
    zs_parent = []
    for jj in range(L1):
        parent_t = mem[jj]
        child_t = mem[jj + 1] if jj + 1 < Lm else st.n_levels
        per = tile_at[:, child_t] if jj + 1 < Lm else \
            np.ones((B, 7), np.float32)
        Sb = np.ones((B, 7), np.float32)
        crossed = [r for r in rout if parent_t < r < child_t]
        for r in crossed:
            Sb *= factors[:, r, :]
        union = per * Sb
        tw_p[:, jj] = _tile_words_np(st, per)
        tw_u[:, jj] = _tile_words_np(st, union)
        ia[:, jj] = inst_before(parent_t)
        ib[:, jj] = inst_before(child_t)
        zs_parent.append(int(st.zs_boundary >= 0
                             and parent_t >= st.zs_boundary))
        fr = np.stack([_fresh_np(st, union, d) if SLIDING[d]
                       else tw_u[:, jj, 0] for d in range(7)], axis=1)
        fresh[:, jj, :] = np.take_along_axis(fr, slot_dim, axis=1)
        if crossed:
            noc_m[:, jj] = 1.0
            for r in crossed:
                sp = factors[:, r, :]
                m_w = (sp[:, [N_, E_, F_]] > 1).any(1)
                m_i = sp[:, M_] > 1
                a_o = (sp[:, [C_, R_, S_]] > 1).any(1)
                k = rout.index(r)
                noc_e[:, jj, 0] += np.where(m_i, st.multi_e[k], st.uni_e[k])
                noc_e[:, jj, 1] += np.where(m_w, st.multi_e[k], st.uni_e[k])
                noc_e[:, jj, 2] += np.where(a_o, st.acc_e[k], st.uni_e[k])

    arrays = [slot_bound, cum, rel_i, rel_w, rel_o, tw_u, tw_p, fresh,
              ia, ib, noc_e, noc_m]
    return arrays, tuple(zs_parent), Lm, L1, S


def _hw_numerics(st: HwStatic):
    """The scalar hardware/workload numerics the single-arch kernel takes
    by value (and the multi-arch kernel reads as per-row arrays)."""
    macs = float(math.prod(st.dims))
    nz = (1.0 - st.in_zf) * (1.0 - (st.w_zf if st.has_weight else 0.0))
    eff = macs * nz if st.zs_boundary >= 0 else macs
    zf = (1.0 - st.in_zf,
          1.0 - (st.w_zf if st.has_weight else 0.0), 1.0)
    return dict(
        macs=macs, eff_macs=eff, zf=zf,
        macs_per_pe=float(st.macs_per_pe), pipeline=float(st.pipeline),
        mac_energy=float(st.mac_e),
        leak_rate=float(sum(st.leak) + st.pe_leak * st.num_pes),
        noc_bw=float(st.noc_bw[0]) if st.noc_bw else 1e30,
        mem_bw=tuple(st.bandwidths), e_read=tuple(st.read_e),
        e_write=tuple(st.write_e))


def pack_for_kernel_arrays(st: HwStatic, factors, rank):
    """Pre-packed arrays -> (host kernel arrays, static dict, n) for the
    single-arch kernel."""
    arrays, zs_parent, Lm, L1, _ = _mapping_rows(st, factors, rank)
    hw = _hw_numerics(st)
    static = dict(
        mem_bw=hw["mem_bw"], e_read=hw["e_read"], e_write=hw["e_write"],
        zs_parent=zs_parent, zf=hw["zf"],
        macs=hw["macs"], macs_per_pe=hw["macs_per_pe"],
        pipeline=hw["pipeline"], mac_energy=hw["mac_energy"],
        eff_macs=hw["eff_macs"], leak_rate=hw["leak_rate"],
        noc_bw=hw["noc_bw"], n_mem=Lm)
    return arrays, static, arrays[0].shape[0]


def pack_for_kernel_multi(groups: List[Tuple[HwStatic, np.ndarray,
                                             np.ndarray]]):
    """Rows of several single-(arch, workload) groups -> one fused host
    batch with per-row hardware constants.

    Every group must share the structural `BatchSig`; the numeric
    hardware/workload constants become [B, ...] arrays:

      zsf     [B, L1, 3]  zero-skip factor per chain pair per tensor
      mem_par [B, Lm, 3]  (bandwidth, read_e, write_e) per memory level
      hw_row  [B, 4]      (comp_scale, eff_mac_pj, leak_rate, noc_bw)
                          with comp_scale = macs / (macs_per_pe * pipeline)
    """
    sig0 = sig_of(groups[0][0])
    per_group = []
    for st, factors, rank in groups:
        if sig_of(st) != sig0:
            raise ValueError("kernel groups must share a BatchSig")
        arrays, zs_parent, Lm, L1, _ = _mapping_rows(st, factors, rank)
        B = arrays[0].shape[0]
        hw = _hw_numerics(st)
        zsf = np.ones((B, L1, 3), np.float32)
        for jj in range(L1):
            if zs_parent[jj]:
                zsf[:, jj, :] = np.asarray(hw["zf"], np.float32)
        mem_par = np.broadcast_to(
            np.stack([hw["mem_bw"], hw["e_read"], hw["e_write"]],
                     axis=-1).astype(np.float32), (B, Lm, 3)).copy()
        hw_row = np.broadcast_to(np.asarray(
            [hw["macs"] / (hw["macs_per_pe"] * hw["pipeline"]),
             hw["eff_macs"] * hw["mac_energy"],
             hw["leak_rate"], hw["noc_bw"]], np.float32), (B, 4)).copy()
        per_group.append(arrays + [zsf, mem_par, hw_row])
    fused = [np.concatenate(parts, axis=0) for parts in zip(*per_group)]
    return fused, fused[0].shape[0]


def _run(fwd, host_arrays, dev: torch.device, **kw):
    """Copy, launch, copy back -> (cycles, energy) float32 numpy."""
    tr = current_tracer()
    with tr.span("kernel.h2d"):
        tensors = [to_device(a, dev) for a in host_arrays]
    with tr.span("kernel.run"):
        cycles, energy = fwd(*tensors, **kw)
        if tr.enabled and dev.type == "cuda":
            torch.cuda.synchronize(dev)
    with tr.span("kernel.d2h"):
        return cycles.cpu().numpy(), energy.cpu().numpy()


def mapspace_eval_arrays(st: HwStatic, factors, rank, *, device="cuda"):
    """-> (cycles [n], energy [n]) float32 numpy from packed arrays."""
    dev = as_device(device)
    with current_tracer().span("kernel.pack"):
        arrays, static, _ = pack_for_kernel_arrays(st, factors, rank)
    return _run(mapspace_eval_fwd, arrays, dev, static=static)


def mapspace_eval_multi(groups: List[Tuple[HwStatic, np.ndarray,
                                           np.ndarray]], *,
                        device="cuda"):
    """-> (cycles [n], energy [n]) over the concatenated group rows, one
    kernel launch for the whole cross-architecture batch."""
    dev = as_device(device)
    with current_tracer().span("kernel.pack"):
        fused, _ = pack_for_kernel_multi(groups)
    return _run(mapspace_eval_multi_fwd, fused, dev)
