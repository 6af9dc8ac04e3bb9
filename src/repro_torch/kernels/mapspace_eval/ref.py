"""Plain PyTorch version of the mapspace-scoring kernel.

The same function as `csrc/mapspace_eval.cu` on the same inputs: the
packed mapspace (`factors`, `rank` [B, L, 7] int32 and `store` [B, Lm, 3]
bool), one float64 record of hardware/workload constants per (architecture,
workload) job, the job row offsets, and the level layout the jobs share.
It derives each row's loop slots, relevance, tile words, input fresh
words, instance counts and NoC energies (`derive_rows`, in the operation
order of the JAX package's host packer, float32), scores them
(`_score_body`) and checks fan-out and buffer capacity in float64
(`validity_ref`).  The wrappers in `kernel.py` compute it for CPU tensors,
the tests compare it with the JAX package, and `chip_smoke.py` holds the
CUDA kernel against it on the card.

Every product below is written as a loop of float32 multiplies, in the
packer's order: `torch.cumprod` and `torch.prod` on the CPU accumulate in
float64, which rounds differently once a product passes 2**24."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

MAX_MEM = 3            # memory levels: make_spatial_arch 3, make_fpga_arch 2
MAX_LEVELS = 6         # tiling levels (memory + routing)
MAX_ROUT = MAX_LEVELS - 2

#: The job record, in the kernel's `JobRec` order: (field, doubles).
REC_FIELDS: Tuple[Tuple[str, int], ...] = (
    ("sizes", MAX_MEM), ("mem_bw", MAX_MEM), ("e_read", MAX_MEM),
    ("e_write", MAX_MEM), ("fanout", MAX_ROUT), ("uni_e", MAX_ROUT),
    ("multi_e", MAX_ROUT), ("acc_e", MAX_ROUT), ("zf", 3), ("macs", 1),
    ("eff_macs", 1), ("macs_per_pe", 1), ("pipeline", 1),
    ("mac_energy", 1), ("leak", 1), ("noc_bw", 1), ("zs_boundary", 1),
    ("stride", 2), ("dilation", 2), ("pad", 1))
REC_OFFSETS = {}
_o = 0
for _name, _n in REC_FIELDS:
    REC_OFFSETS[_name] = (_o, _n)
    _o += _n
REC_DOUBLES = _o                 # 44: a record is 352 bytes, 22 x 16
del _o, _name, _n

# dims N M C R S E F -> bit d; relevance per tensor, sliding dims
REL_MASKS = (0x7D, 0x1E, 0x63)   # input, weight, output
REL_OUT_DEPTHWISE = 0x67
SLIDING_MASK = 0x78              # R S E F
N_, M_, C_, R_, S_, E_, F_ = range(7)


class Layout(NamedTuple):
    """The level layout and tensor set all jobs of a launch share (the
    structural `BatchSig`)."""
    n_levels: int
    mem_idx: Tuple[int, ...]
    rout_idx: Tuple[int, ...]
    depthwise: bool
    has_weight: bool


def field(rec: torch.Tensor, name: str) -> torch.Tensor:
    """[B, REC_DOUBLES] records -> [B, n] (or [B] for a scalar field)."""
    o, n = REC_OFFSETS[name]
    return rec[:, o] if n == 1 else rec[:, o:o + n]


def row_records(jobs: torch.Tensor, offsets, n_rows: int) -> torch.Tensor:
    """Job records [J, REC] and row offsets [J+1] -> one record per row."""
    if offsets is None:
        return jobs.reshape(1, REC_DOUBLES).expand(n_rows, REC_DOUBLES)
    counts = (offsets[1:] - offsets[:-1]).to(torch.int64)
    return jobs.repeat_interleave(counts, dim=0)


def _prod(cols):
    """Left-to-right float32 product of a list of [B] tensors."""
    out = cols[0]
    for c in cols[1:]:
        out = out * c
    return out


def _tile_words(tile, u, v, dr, ds, layout: Layout):
    """tile [B, 7] -> [B, 3] words (input, weight, output), in the dtype of
    `tile`; `u, v, dr, ds` [B] of the same dtype."""
    n, m, c, r, s, e, f = tile.unbind(1)
    p = (e - 1) * u + (r - 1) * dr + 1
    q = (f - 1) * v + (s - 1) * ds + 1
    w = (r * s * c * m) if layout.has_weight else torch.zeros_like(n)
    o = n * e * f * (c if layout.depthwise else m)
    return torch.stack([n * c * p * q, w, o], dim=1)


def _fresh(tile, d: int, u, v, dr, ds):
    """Input words fresh in one slide step along dim `d` (R, S, E or F)."""
    n, m, c, r, s, e, f = tile.unbind(1)
    p = (e - 1) * u + (r - 1) * dr + 1
    q = (f - 1) * v + (s - 1) * ds + 1
    if d == E_:
        return n * c * torch.minimum(p, e * u) * q
    if d == F_:
        return n * c * p * torch.minimum(q, f * v)
    if d == R_:
        return n * c * torch.minimum(p, r * dr) * q
    return n * c * p * torch.minimum(q, s * ds)


def _tile_at(f, level: int):
    """Per-dim tile extent below tiling index `level`: the product of the
    factors of levels >= level, multiplied from the innermost level out
    (numpy's flip-cumprod-flip).  `level == L` (compute) gives ones."""
    B, L, _ = f.shape
    out = torch.ones((B, 7), dtype=f.dtype, device=f.device)
    for k in range(L - 1, level - 1, -1):
        out = out * f[:, k, :]
    return out


def _stride(rec, dtype):
    u, v = field(rec, "stride").to(dtype).unbind(1)
    dr, ds = field(rec, "dilation").to(dtype).unbind(1)
    return u, v, dr, ds


def derive_rows(factors, rank, rec, layout: Layout):
    """The twelve per-row quantities the JAX package's host packer
    (`ops._mapping_rows`) derives, float32, in its operation order:

      slot_bound, cum, rel_i, rel_w, rel_o  [B, S]   S = 7 Lm slots
      tw_u, tw_p                            [B, L1, 3] union / per-instance
                                                       tile words
      fresh                                 [B, L1, S] input fresh words
      ia, ib                                [B, L1]  parent / child instances
      noc_e                                 [B, L1, 3] NoC pJ a word
      noc_m                                 [B, L1]  1 if the pair crosses
                                                     a NoC

    `rec` [B, REC] holds each row's job record."""
    f = factors.to(torch.float32)
    rank = rank.to(torch.int64)
    B, L, _ = f.shape
    dev = f.device
    mem, rout = list(layout.mem_idx), list(layout.rout_idx)
    Lm = len(mem)
    S = 7 * Lm
    u, v, dr, ds = _stride(rec, torch.float32)

    slot_bound = torch.ones((B, S), dtype=torch.float32, device=dev)
    slot_dim = torch.zeros((B, S), dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    for j, li in enumerate(mem):
        for d in range(7):                   # a later dim overwrites, as
            idx = j * 7 + rank[:, li, d]     # numpy's fancy assignment does
            slot_bound[rows, idx] = f[:, li, d]
            slot_dim[rows, idx] = d
    cols = list(slot_bound.unbind(1))
    cum = [cols[0]]
    for c in cols[1:]:
        cum.append(cum[-1] * c)
    cum = torch.stack(cum, 1)

    bits = lambda mask: torch.tensor([(mask >> d) & 1 for d in range(7)],
                                     dtype=torch.float32,
                                     device=dev)[slot_dim]
    rel_i, rel_w = bits(REL_MASKS[0]), bits(REL_MASKS[1])
    rel_o = bits(REL_OUT_DEPTHWISE if layout.depthwise else REL_MASKS[2])

    rout_prod = {r: _prod(list(f[:, r, :].unbind(1))) for r in rout}

    def inst_before(tiling_idx):
        inst = torch.ones((B,), dtype=torch.float32, device=dev)
        for r in rout:
            if r < tiling_idx:
                inst = inst * rout_prod[r]
        return inst

    uni, multi, acc = (field(rec, k) for k in ("uni_e", "multi_e", "acc_e"))
    tw_u, tw_p, fresh, ia, ib, noc_e, noc_m = [], [], [], [], [], [], []
    for jj in range(Lm):
        parent_t = mem[jj]
        child_t = mem[jj + 1] if jj + 1 < Lm else L
        per = _tile_at(f, child_t)
        sb = torch.ones((B, 7), dtype=torch.float32, device=dev)
        crossed = [r for r in rout if parent_t < r < child_t]
        for r in crossed:
            sb = sb * f[:, r, :]
        union = per * sb
        tw_p.append(_tile_words(per, u, v, dr, ds, layout))
        tw_u.append(_tile_words(union, u, v, dr, ds, layout))
        ia.append(inst_before(parent_t))
        ib.append(inst_before(child_t))
        fr = torch.stack([_fresh(union, d, u, v, dr, ds)
                          if (SLIDING_MASK >> d) & 1 else tw_u[-1][:, 0]
                          for d in range(7)], 1)
        fresh.append(fr.gather(1, slot_dim))
        ne = torch.zeros((B, 3), dtype=torch.float32, device=dev)
        for r in crossed:
            sp = f[:, r, :]
            m_w = (sp[:, [N_, E_, F_]] > 1).any(1)
            m_i = sp[:, M_] > 1
            a_o = (sp[:, [C_, R_, S_]] > 1).any(1)
            k = rout.index(r)
            add = torch.stack([torch.where(m_i, multi[:, k], uni[:, k]),
                               torch.where(m_w, multi[:, k], uni[:, k]),
                               torch.where(a_o, acc[:, k], uni[:, k])], 1)
            ne = (ne.to(torch.float64) + add).to(torch.float32)
        noc_e.append(ne)
        noc_m.append(torch.full((B,), 1.0 if crossed else 0.0,
                                dtype=torch.float32, device=dev))
    st = lambda xs: torch.stack(xs, 1)
    return [slot_bound, cum, rel_i, rel_w, rel_o, st(tw_u), st(tw_p),
            st(fresh), st(ia), st(ib), st(noc_e), st(noc_m)]


def validity_ref(factors, store, rec, layout: Layout) -> torch.Tensor:
    """Fan-out and buffer capacity per row, in float64 (exact for these
    integer products): the product of every routing level's factors is at
    most its fan-out, and at every memory level the staged tile words sum
    to at most its size (an unbounded level's size is inf)."""
    f = factors.to(torch.float64)
    valid = torch.ones((f.shape[0],), dtype=torch.bool, device=f.device)
    fanout = field(rec, "fanout")
    for k, r in enumerate(layout.rout_idx):
        valid &= f[:, r, :].prod(1) <= fanout[:, k]
    u, v, dr, ds = _stride(rec, torch.float64)
    sizes = field(rec, "sizes")
    for j, li in enumerate(layout.mem_idx):
        words = _tile_words(_tile_at(f, li), u, v, dr, ds, layout)
        used = torch.where(store[:, j, :], words, 0.0).sum(1)
        valid &= used <= sizes[:, j]
    return valid


def _score_body(bounds, cum, rel_i, rel_w, rel_o, tw_u, tw_p, fresh, ia, ib,
                noc_e, noc_m, *, n_mem: int, zsf_of, mem_bw_of, e_read_of,
                e_write_of, comp_cycles_of, dyn0, leak, noc_bw):
    """The scoring pipeline of the JAX package's `_score_body`.  The `*_of`
    getters return [B] tensors of per-row constants."""
    B, S = bounds.shape
    dev = bounds.device
    pos = torch.arange(1, S + 1, device=dev)
    active = bounds > 1.0
    rel = (rel_i > 0, rel_w > 0, rel_o > 0)
    zeros = lambda: torch.zeros((B,), dtype=torch.float32, device=dev)
    reads = [zeros() for _ in range(n_mem)]
    writes = [zeros() for _ in range(n_mem)]
    raw = [zeros() for _ in range(n_mem)]
    noc_words = zeros()
    dyn = dyn0

    L1 = n_mem
    for j in range(L1):
        i_a, i_b, nm = ia[:, j], ib[:, j], noc_m[:, j]
        visible = pos <= 7 * (j + 1)
        is_term = j == L1 - 1
        for t in range(3):
            u, p = tw_u[:, j, t], tw_p[:, j, t]
            r = visible & rel[t] & active                    # [B, S]
            k1 = torch.where(r, pos, 0).amax(1)              # 1-based slot
            has = k1 > 0
            k = torch.clamp(k1 - 1, min=0)[:, None]
            p_k = torch.where(has, cum.gather(1, k)[:, 0], 1.0)
            b_k = torch.where(has, bounds.gather(1, k)[:, 0], 1.0)
            vv = p_k
            outer = p_k / b_k
            zsf = zsf_of(j, t)
            ne = noc_e[:, j, t]
            if t == 2:                                       # output
                dd = torch.prod(torch.where(r, bounds, 1.0), 1)
                p_rd = i_a * (vv - dd) * u
                p_wr = i_a * vv * u
                reads[j] = reads[j] + p_rd * zsf
                writes[j] = writes[j] + p_wr * zsf
                raw[j] = raw[j] + (p_rd + p_wr)
                if not is_term:
                    c_rd = i_b * vv * p
                    c_wr = i_b * (vv - dd) * p
                    reads[j + 1] = reads[j + 1] + c_rd * zsf
                    writes[j + 1] = writes[j + 1] + c_wr * zsf
                    raw[j + 1] = raw[j + 1] + (c_rd + c_wr)
                nw = i_b * (2 * vv - dd) * p * nm
            else:
                if t == 0:                                   # input: halo
                    fr = fresh[:, j, :].gather(1, k)[:, 0]
                    words = torch.where(has, outer * (u + (b_k - 1.0) * fr),
                                        u)
                else:
                    words = torch.where(has, vv * u, u)
                p_rd = i_a * words
                reads[j] = reads[j] + p_rd * zsf
                raw[j] = raw[j] + p_rd
                if not is_term:
                    c_wr = i_b * vv * p
                    writes[j + 1] = writes[j + 1] + c_wr * zsf
                    raw[j + 1] = raw[j + 1] + c_wr
                nw = p_rd * nm
            noc_words = noc_words + nw
            dyn = dyn + nw * zsf * ne

    cycles = comp_cycles_of(torch.clamp(ib[:, L1 - 1], min=1.0))
    for m in range(n_mem):
        cycles = torch.maximum(cycles, raw[m] / (mem_bw_of(m) * ia[:, m]))
        dyn = dyn + (reads[m] * e_read_of(m) + writes[m] * e_write_of(m))
    cycles = torch.maximum(cycles, noc_words / noc_bw)
    return cycles, dyn + leak * cycles


def score_rows(rows, rec, layout: Layout):
    """Derived rows + per-row records -> (cycles, energy) float32."""
    f32 = lambda x: x.to(torch.float32)
    mem = layout.mem_idx
    zsb = field(rec, "zs_boundary")
    zf = f32(field(rec, "zf"))
    zs_parent = [(zsb >= 0) & (mem[j] >= zsb) for j in range(len(mem))]
    return _score_body(
        *rows, n_mem=len(mem),
        zsf_of=lambda j, t: torch.where(zs_parent[j], zf[:, t], 1.0),
        mem_bw_of=lambda m: f32(field(rec, "mem_bw")[:, m]),
        e_read_of=lambda m: f32(field(rec, "e_read")[:, m]),
        e_write_of=lambda m: f32(field(rec, "e_write")[:, m]),
        comp_cycles_of=lambda pes: f32(field(rec, "macs") / (
            field(rec, "macs_per_pe") * field(rec, "pipeline"))) / pes,
        dyn0=f32(field(rec, "eff_macs") * field(rec, "mac_energy")),
        leak=f32(field(rec, "leak")), noc_bw=f32(field(rec, "noc_bw")))


def score_multi_ref(factors, rank, store, jobs, offsets, *, layout: Layout):
    """Rows of the jobs `jobs` [J, REC] float64, job j owning rows
    offsets[j]:offsets[j+1] -> (cycles [B] float32, energy [B] float32,
    valid [B] bool)."""
    rec = row_records(jobs, offsets, factors.shape[0])
    cycles, energy = score_rows(derive_rows(factors, rank, rec, layout),
                                rec, layout)
    return cycles, energy, validity_ref(factors, store, rec, layout)


def score_ref(factors, rank, store, job, *, layout: Layout):
    """One job: `job` [REC] float64 -> (cycles, energy, valid)."""
    return score_multi_ref(factors, rank, store, job, None, layout=layout)
