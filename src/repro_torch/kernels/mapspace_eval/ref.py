"""Plain PyTorch version of the mapspace-scoring kernel.

The same function as `csrc/mapspace_eval.cu` over the same twelve (or
fifteen) per-row tensors, written as batched tensor code: the wrappers in
`kernel.py` compute it for CPU tensors, the tests compare it with the JAX
package's Pallas kernels, and `chip_smoke.py` holds the CUDA kernel
against it on the card."""
from __future__ import annotations

import torch


def _score_body(bounds, cum, rel_i, rel_w, rel_o, tw_u, tw_p, fresh, ia, ib,
                noc_e, noc_m, *, n_mem: int, zsf_of, mem_bw_of, e_read_of,
                e_write_of, comp_cycles_of, dyn0, leak, noc_bw):
    """The scoring pipeline shared by both variants.  The `*_of` getters
    return host floats (single architecture) or [B] tensors (per row) —
    the arithmetic broadcasts identically."""
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


def score_ref(bounds, cum, rel_i, rel_w, rel_o, tw_u, tw_p, fresh, ia, ib,
              noc_e, noc_m, *, static: dict):
    """Single architecture: constants from the packer's `static` dict."""
    zf, zs_parent = static["zf"], static["zs_parent"]
    dyn0 = torch.full((bounds.shape[0],),
                      static["eff_macs"] * static["mac_energy"],
                      dtype=torch.float32, device=bounds.device)
    return _score_body(
        bounds, cum, rel_i, rel_w, rel_o, tw_u, tw_p, fresh, ia, ib,
        noc_e, noc_m, n_mem=static["n_mem"],
        zsf_of=lambda j, t: zf[t] if zs_parent[j] else 1.0,
        mem_bw_of=lambda m: static["mem_bw"][m],
        e_read_of=lambda m: static["e_read"][m],
        e_write_of=lambda m: static["e_write"][m],
        comp_cycles_of=lambda pes: static["macs"] / (
            pes * static["macs_per_pe"] * static["pipeline"]),
        dyn0=dyn0, leak=static["leak_rate"], noc_bw=static["noc_bw"])


def score_multi_ref(bounds, cum, rel_i, rel_w, rel_o, tw_u, tw_p, fresh,
                    ia, ib, noc_e, noc_m, zsf, mem_par, hw_row):
    """Per-row constants: zsf [B, L1, 3], mem_par [B, Lm, 3], hw_row [B, 4]
    = (macs / (macs_per_pe * pipeline), dynamic MAC pJ, leakage, NoC
    bandwidth)."""
    return _score_body(
        bounds, cum, rel_i, rel_w, rel_o, tw_u, tw_p, fresh, ia, ib,
        noc_e, noc_m, n_mem=mem_par.shape[1],
        zsf_of=lambda j, t: zsf[:, j, t],
        mem_bw_of=lambda m: mem_par[:, m, 0],
        e_read_of=lambda m: mem_par[:, m, 1],
        e_write_of=lambda m: mem_par[:, m, 2],
        comp_cycles_of=lambda pes: hw_row[:, 0] / pes,
        dyn0=hw_row[:, 1], leak=hw_row[:, 2], noc_bw=hw_row[:, 3])
