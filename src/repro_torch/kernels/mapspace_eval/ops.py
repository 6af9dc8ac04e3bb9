"""Packed mapspace arrays -> the kernel -> scores and validity.

The kernel reads the packed mapspace as the mapper made it (`factors`,
`rank` int32, `store` bool) and one float64 record of constants per
(architecture, workload) job (`job_record`); the host copies them to the
device as they are, launches, and copies (cycles, energy, valid) back.  Two
entry points:

  * `mapspace_eval_arrays(st, f, r, s, device=...)` — one
    hardware/workload pair (the single-job launch);
  * `mapspace_eval_multi(groups, device=...)` — rows from several
    `(HwStatic, factors, rank, store)` groups sharing one `BatchSig` fuse
    into ONE launch, each group one job of the record table (the
    `core.batch_eval.evaluate_batch_multi` contract).

Only no-bypass mappings are accepted (the kernel's storage chains are the
full memory hierarchy); the general path is core.batch_eval, and
`core.backend.score_mapspace` splits a mapspace between the two.

Spans (ambient tracer): `kernel.h2d`, `kernel.run` (launch; synchronised
only while a tracer records, so the split is honest) and `kernel.d2h`.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ...core.batch_eval import HwStatic, sig_of
from ...device import as_device, to_device
from ...obs import current_tracer
from .kernel import mapspace_eval_fwd, mapspace_eval_multi_fwd
from .ref import MAX_ROUT, REC_DOUBLES, REC_OFFSETS, Layout


def _hw_numerics(st: HwStatic):
    """The scalar hardware/workload numerics of the JAX package's packer
    (`ops._hw_numerics`), as the job record carries them."""
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


def layout_of(st: HwStatic) -> Layout:
    """The structural part of `st` that every job of a launch shares."""
    return Layout(n_levels=st.n_levels, mem_idx=tuple(st.mem_idx),
                  rout_idx=tuple(st.rout_idx), depthwise=bool(st.depthwise),
                  has_weight=bool(st.has_weight))


def job_record(st: HwStatic) -> np.ndarray:
    """-> [REC_DOUBLES] float64, the kernel's `JobRec` for one job."""
    if len(st.rout_idx) > MAX_ROUT:
        raise ValueError(f"kernel supports {MAX_ROUT} routing levels, got "
                         f"{len(st.rout_idx)}")
    hw = _hw_numerics(st)
    rec = np.zeros((REC_DOUBLES,), np.float64)

    def put(name, values):
        o, _ = REC_OFFSETS[name]
        values = np.atleast_1d(np.asarray(values, np.float64))
        rec[o:o + values.shape[0]] = values

    put("sizes", st.sizes)
    put("mem_bw", hw["mem_bw"])
    put("e_read", hw["e_read"])
    put("e_write", hw["e_write"])
    put("fanout", [float(f) for f in st.fanout])
    put("uni_e", st.uni_e)
    put("multi_e", st.multi_e)
    put("acc_e", st.acc_e)
    put("zf", hw["zf"])
    for name in ("macs", "eff_macs", "macs_per_pe", "pipeline",
                 "mac_energy", "noc_bw"):
        put(name, hw[name])
    put("leak", hw["leak_rate"])
    put("zs_boundary", float(st.zs_boundary))
    put("stride", [float(s) for s in st.stride])
    put("dilation", [float(d) for d in st.dilation])
    return rec


def _run(fwd, host_arrays, dev: torch.device, **kw):
    """Copy, launch, copy back -> (cycles, energy, valid) numpy."""
    tr = current_tracer()
    with tr.span("kernel.h2d"):
        tensors = [to_device(a, dev) for a in host_arrays]
    with tr.span("kernel.run"):
        out = fwd(*tensors, **kw)
        if tr.enabled and dev.type == "cuda":
            torch.cuda.synchronize(dev)
    with tr.span("kernel.d2h"):
        return tuple(t.cpu().numpy() for t in out)


def mapspace_eval_arrays(st: HwStatic, factors, rank, store, *,
                         device="cuda"):
    """-> (cycles [n] float32, energy [n] float32, valid [n] bool) numpy
    from one job's packed arrays."""
    dev = as_device(device)
    return _run(mapspace_eval_fwd,
                [np.ascontiguousarray(factors, np.int32),
                 np.ascontiguousarray(rank, np.int32),
                 np.ascontiguousarray(store, bool), job_record(st)], dev,
                layout=layout_of(st))


def mapspace_eval_multi(groups: List[Tuple[HwStatic, np.ndarray,
                                           np.ndarray, np.ndarray]], *,
                        device="cuda"):
    """-> (cycles [n], energy [n], valid [n]) over the concatenated group
    rows, one kernel launch for the whole cross-architecture batch."""
    dev = as_device(device)
    sig0 = sig_of(groups[0][0])
    if any(sig_of(st) != sig0 for st, *_ in groups):
        raise ValueError("kernel groups must share a BatchSig")
    counts = [np.shape(f)[0] for _, f, _, _ in groups]
    offsets = np.zeros((len(groups) + 1,), np.int32)
    offsets[1:] = np.cumsum(counts)
    cat = lambda i, dtype: np.concatenate([g[i] for g in groups]).astype(
        dtype, copy=False)
    return _run(mapspace_eval_multi_fwd,
                [cat(1, np.int32), cat(2, np.int32), cat(3, bool),
                 np.stack([job_record(st) for st, *_ in groups]), offsets],
                dev, layout=layout_of(groups[0][0]))
