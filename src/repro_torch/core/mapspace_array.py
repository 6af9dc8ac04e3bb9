"""Array-native mapspace pipeline: `PackedMapspace` (paper §5, vectorized).

The seed mapper materialized up to `max_mappings` Python `Mapping` objects
per (architecture, workload), validated them one `buffer_words()` call at
a time, and every scoring consumer re-packed the same objects into arrays
(`batch_eval.pack`).  End-to-end DSE time was therefore dominated by the
Python front-end, not the vectorized evaluator.

`PackedMapspace` makes the packed tensors the *primary* representation:

    factors [B, L, 7]   int32  loop bounds per tiling level per dim
    rank    [B, L, 7]   int32  dim position in the level's loop order
    store   [B, Lm, 3]  bool   staged tensors per memory level (pack())

plus the candidate index rows (fi/oi/bi into `MapspaceTables`) that let
`materialize(i)` rebuild the i-th survivor as a `Mapping` object lazily —
in a search only the per-job *winner* is ever materialized.

Construction, validation (fanout, buffer capacities including reserved
inter-layer activation words and split-buffer sizes — the full
`mapper.validate` semantics) and the §5.2 utilization pruning are batched
numpy formulas over the whole candidate set.  Candidates come from the
same index-row generator as `mapper.build_mapspace` (the exact-parity
legacy object path), so the two pipelines describe the same candidate
set, elect the same survivors in the same order, and agree bit-for-bit —
asserted by the JAX package's tests/test_mapspace_array.py.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional

import numpy as np

from .batch_eval import HwStatic, make_static, tile_words_np
from .designer import HardwareDesc
from .mapper import (MapperConfig, MapspaceTables, candidate_index_rows,
                     materialize_row)
from .mapping import Mapping
from .workload import TENSORS, Workload


@dataclasses.dataclass
class PackedMapspace:
    """A mapspace as packed arrays (survivors only: valid + §5.2-pruned).

    The array triplet (factors, rank, store) is exactly what
    `batch_eval.pack` would produce for the equivalent `Mapping` list, so
    every array consumer (`evaluate_batch`, `evaluate_batch_multi`, the
    CUDA kernels, `validity_mask_arrays`) takes it unchanged — zero re-packing
    anywhere downstream.

    `eligible` is the kernel eligibility per row: no tensor bypasses any
    level (bypass-choice 0 is the empty set at every level).  The index
    rows and tables are None for a mapspace assembled from arrays alone
    (`repro_torch.convert.packed_from_arrays`), which scores but cannot
    materialize.
    """
    workload: Optional[Workload]
    hardware: Optional[HardwareDesc]
    static: HwStatic
    factors: np.ndarray                 # [B, L, 7] int32
    rank: np.ndarray                    # [B, L, 7] int32
    store: np.ndarray                   # [B, Lm, 3] bool
    eligible: np.ndarray                # [B] bool
    fi: Optional[np.ndarray]            # [B, 7] candidate index rows
    oi: Optional[np.ndarray]            # [B, L] (-1 for routing levels)
    bi: Optional[np.ndarray]            # [B, L]
    tables: Optional[MapspaceTables]
    total_candidates: int               # full cartesian size
    n_valid: int                        # valid candidates before pruning

    def __len__(self) -> int:
        return int(self.factors.shape[0])

    def materialize(self, i: int) -> Mapping:
        """Rebuild survivor `i` as a `Mapping` object (lazy; a search
        materializes only each job's winner)."""
        if self.tables is None:
            raise ValueError("mapspace was assembled from arrays alone; "
                             "it has no index rows to materialize")
        return materialize_row(self.tables, self.workload, self.hardware,
                               self.fi[i], self.oi[i], self.bi[i])

    def materialize_all(self) -> List[Mapping]:
        return [self.materialize(i) for i in range(len(self))]

    def digest(self) -> str:
        """Content hash of the packed arrays (cache key component)."""
        h = hashlib.sha256()
        for a in (self.factors, self.rank, self.store):
            h.update(np.ascontiguousarray(a).tobytes())
            h.update(repr(a.shape).encode())
        return h.hexdigest()


# ---------------------------------------------------------------------------
# array assembly
# ---------------------------------------------------------------------------
def assemble_arrays(tables: MapspaceTables, st: HwStatic, has_weight: bool,
                    fi: np.ndarray, oi: np.ndarray, bi: np.ndarray):
    """Candidate index rows -> (factors, rank, store) with
    `batch_eval.pack` semantics (DRAM always stages everything)."""
    B = fi.shape[0]
    L = tables.nl
    mem = tables.mem_idx
    factors = np.ones((B, L, 7), np.int32)
    for d in range(7):
        tab = np.asarray([list(t) for t in tables.per_dim[d]], np.int32)
        factors[:, :, d] = tab[fi[:, d]]
    order_tab = np.asarray(tables.orders, np.int32)         # [n_o, 7]
    rank_tab = np.argsort(order_tab, axis=1).astype(np.int32)
    rank = np.zeros((B, L, 7), np.int32)
    for li in mem:
        rank[:, li, :] = rank_tab[oi[:, li]]
    store = np.ones((B, len(mem), 3), bool)
    for j, li in enumerate(mem):
        choice_tab = np.asarray(
            [[li == 0 or ((t != "weight" or has_weight) and t not in bset)
              for t in TENSORS] for bset in tables.bypass_choices[li]], bool)
        store[:, j, :] = choice_tab[bi[:, li]]
    return factors, rank, store


# ---------------------------------------------------------------------------
# vectorized validation + pruning (mapper.validate / mapper.prune parity)
# ---------------------------------------------------------------------------
def packed_validity(hw: HardwareDesc, st: HwStatic, factors: np.ndarray,
                    store: np.ndarray,
                    act_reserve: Optional[Dict[str, float]] = None
                    ) -> np.ndarray:
    """Batched `mapper.validate`: spatial fan-out + buffer capacities with
    reserved activation words and split-buffer sizes.  All arithmetic in
    float64 (exact for the integer word counts involved)."""
    f = factors.astype(np.float64)
    B = f.shape[0]
    valid = np.ones((B,), bool)
    for li, lv in enumerate(hw.tiling_levels):
        if lv.kind == "routing":
            valid &= f[:, li, :].prod(axis=1) <= lv.fanout
    tile_at = np.flip(np.cumprod(np.flip(f, 1), axis=1), 1)    # [B, L, 7]
    act_reserve = act_reserve or {}
    for j, li in enumerate(st.mem_idx):
        lv = hw.tiling_levels[li]
        if lv.size_words is None:
            continue
        words = tile_words_np(st, tile_at[:, li])              # [B, 3]
        buf = np.where(store[:, j, :], words, 0.0)
        if lv.usage == "split" and lv.split_sizes is not None:
            for ti in range(3):
                valid &= buf[:, ti] <= lv.split_sizes[ti]
        else:
            reserve = act_reserve.get(lv.name, 0.0)
            valid &= buf.sum(axis=1) + reserve <= lv.size_words
    return valid


def packed_prune_mask(hw: HardwareDesc, st: HwStatic, cfg: MapperConfig,
                      factors: np.ndarray, store: np.ndarray) -> np.ndarray:
    """Batched §5.2 utilization pruner (keep-mask over candidates)."""
    f = factors.astype(np.float64)
    B = f.shape[0]
    keep = np.ones((B,), bool)
    if cfg.pe_utilization_min > 0.0:
        used = np.ones((B,), np.float64)
        for r in st.rout_idx:
            used *= f[:, r, :].prod(axis=1)
        keep &= used >= cfg.pe_utilization_min * hw.total_pes()
    if cfg.innermem_utilization_min > 0.0:
        li = st.mem_idx[-1]
        j = len(st.mem_idx) - 1
        lv = hw.tiling_levels[li]
        if lv.size_words:
            tile = np.flip(np.cumprod(np.flip(f[:, li:], 1), axis=1),
                           1)[:, 0]                            # [B, 7]
            words = tile_words_np(st, tile)
            used = np.where(store[:, j, :], words, 0.0).sum(axis=1)
            keep &= used >= cfg.innermem_utilization_min * lv.size_words
    return keep


# ---------------------------------------------------------------------------
# the builder
# ---------------------------------------------------------------------------
def build_packed_mapspace(workload: Workload, hw: HardwareDesc,
                          cfg: Optional[MapperConfig] = None
                          ) -> PackedMapspace:
    """Array-native `build_mapspace`: enumerate/sample -> assemble ->
    validate -> prune, all batched; bit-exact with the object path.

    Emits `pack` (enumeration/sampling + array assembly) and `validate`
    (vectorized validity + §5.2 pruning) phase spans into the ambient
    `repro_torch.obs` tracer (no-op by default)."""
    from ..obs import current_tracer
    cfg = cfg or MapperConfig()
    tr = current_tracer()
    with tr.span("pack", phase=True, workload=workload.name,
                 arch=hw.name) as sp:
        tables, fi, oi, bi = candidate_index_rows(workload, hw, cfg)
        st = make_static(hw, workload)
        factors, rank, store = assemble_arrays(
            tables, st, workload.has_weight, fi, oi, bi)
        sp.set(candidates=int(fi.shape[0]), total=tables.total)
    with tr.span("validate", phase=True, workload=workload.name) as sp:
        valid = packed_validity(hw, st, factors, store, cfg.act_reserve)
        n_valid = int(valid.sum())
        keep = valid & packed_prune_mask(hw, st, cfg, factors, store)
        # pruning fallback: if the §5.2 constraints empty the space, keep
        # the valid set (mapper.build_mapspace semantics)
        idx = np.flatnonzero(keep if keep.any() else valid)
        sp.set(n_valid=n_valid, survivors=int(idx.shape[0]))
    tr.metrics.histogram("mapspace.rows").observe(int(idx.shape[0]))
    return PackedMapspace(
        workload=workload, hardware=hw, static=st,
        factors=factors[idx], rank=rank[idx], store=store[idx],
        eligible=np.all(bi[idx] == 0, axis=1),
        fi=fi[idx], oi=oi[idx], bi=bi[idx], tables=tables,
        total_candidates=tables.total, n_valid=n_valid)



def packed_candidates(workload: Workload, hw: HardwareDesc,
                      cfg: Optional[MapperConfig] = None):
    """Debug/test hook: the full candidate set before filtering.
    -> (tables, factors, rank, store, valid_mask, keep_mask)."""
    cfg = cfg or MapperConfig()
    tables, fi, oi, bi = candidate_index_rows(workload, hw, cfg)
    st = make_static(hw, workload)
    factors, rank, store = assemble_arrays(tables, st, workload.has_weight,
                                           fi, oi, bi)
    valid = packed_validity(hw, st, factors, store, cfg.act_reserve)
    keep = valid & packed_prune_mask(hw, st, cfg, factors, store)
    return tables, factors, rank, store, valid, keep
