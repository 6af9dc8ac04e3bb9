"""Lower the assigned LM architectures to TRIM intra-layer workloads.

Every transformer/SSM layer op whose primary computation is a (batched)
matmul maps onto the paper's 7-dim loop nest (paper §3.2: "matrix-matrix
multiplications can be defined by setting R, S, E, F equal to 1").  This
extends TRIM's task analyst beyond CONV/POOL/FC to the modern-architecture
pool: it is how the DSE sees the LM configurations as workloads.

For training shapes each matmul also emits BW/WG workloads (transposed
operand roles, same MAC count) — the paper's FC-layer treatment.

A framework-free copy of the JAX package's `core/lower_lm.py` over the
port's own `configs`: the port imports nothing of that package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec
from .workload import Workload, matmul_workload


@dataclasses.dataclass
class LoweredLM:
    workloads: List[Workload]            # one block's workloads
    repeat: int                          # x n_layers
    tail: List[Workload]                 # unrepeated (lm head, ...)

    def all_workloads(self) -> List[Workload]:
        return list(self.workloads) * self.repeat + list(self.tail)

    def total_macs(self) -> int:
        per = sum(w.macs for w in self.workloads)
        return per * self.repeat + sum(w.macs for w in self.tail)


def _mm(name, rows, cols, inner, phase="FW"):
    return matmul_workload(rows=int(rows), cols=int(cols), inner=int(inner),
                           name=name, phase=phase)


def _with_training(wls: List[Workload], training: bool) -> List[Workload]:
    if not training:
        return wls
    out = list(wls)
    for w in wls:
        n, m, c = w.dims[0], w.dims[1], w.dims[2]
        out.append(_mm(w.name + ".BW", n, c, m, phase="BW"))
        out.append(_mm(w.name + ".WG", c, m, n, phase="WG"))
    return out


def lower_block(cfg: ModelConfig, spec: ShapeSpec) -> LoweredLM:
    """Workloads of one representative block + tail (head)."""
    b, s = spec.global_batch, spec.seq_len
    training = spec.kind == "train"
    decode = spec.kind == "decode"
    sq = 1 if decode else s              # query length
    t = b * sq                           # tokens processed this step
    d = cfg.d_model
    wls: List[Workload] = []

    if cfg.attn == "mla":
        r = cfg.kv_lora_rank
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        if cfg.q_lora_rank:
            wls.append(_mm("q_a", t, cfg.q_lora_rank, d))
            wls.append(_mm("q_b", t, cfg.n_heads * qk, cfg.q_lora_rank))
        else:
            wls.append(_mm("q", t, cfg.n_heads * qk, d))
        wls.append(_mm("kv_a", t, r + cfg.qk_rope_dim, d))
        kv_len = s
        wls.append(_mm("k_expand", (b * kv_len if not decode else t),
                       cfg.n_heads * cfg.qk_nope_dim, r))
        wls.append(_mm("v_expand", (b * kv_len if not decode else t),
                       cfg.n_heads * cfg.v_head_dim, r))
        wls.append(_mm("scores", b * cfg.n_heads * sq, kv_len, qk))
        wls.append(_mm("attn_v", b * cfg.n_heads * sq, cfg.v_head_dim,
                       kv_len))
        wls.append(_mm("o", t, d, cfg.n_heads * cfg.v_head_dim))
    elif cfg.attn == "gqa" and cfg.n_heads:
        hd = cfg.d_head
        wls.append(_mm("q", t, cfg.n_heads * hd, d))
        wls.append(_mm("k", t, cfg.n_kv_heads * hd, d))
        wls.append(_mm("v", t, cfg.n_kv_heads * hd, d))
        kv_len = s
        eff = min(kv_len, cfg.sliding_window) if (cfg.sliding_window and
                                                  decode) else kv_len
        causal_frac = 0.5 if (not decode and cfg.sliding_window == 0) else 1.0
        wls.append(_mm("scores", int(b * cfg.n_heads * sq * causal_frac),
                       eff, hd))
        wls.append(_mm("attn_v", int(b * cfg.n_heads * sq * causal_frac),
                       hd, eff))
        wls.append(_mm("o", t, d, cfg.n_heads * hd))

    if cfg.family in ("ssm", "hybrid"):
        di = cfg.d_inner
        g, n = cfg.ssm_ngroups, cfg.d_state
        nh, p = cfg.n_ssm_heads, cfg.ssm_headdim
        wls.append(_mm("ssm_in", t, 2 * di + 2 * g * n + nh, d))
        if decode:
            wls.append(_mm("ssm_state", b * nh, n, p))
            wls.append(_mm("ssm_out_state", b * nh, p, n))
        else:
            q = cfg.chunk
            nc = max(s // q, 1)
            wls.append(_mm("ssd_scores", b * nc * nh * q, q, n))
            wls.append(_mm("ssd_diag", b * nc * nh * q, p, q))
            wls.append(_mm("ssd_states", b * nc * nh * n, p, q))
            wls.append(_mm("ssd_off", b * nc * nh * q, p, n))
        wls.append(_mm("ssm_out", t, d, di))

    if cfg.family == "moe":
        e, k, f = cfg.n_experts, cfg.top_k, cfg.d_expert
        wls.append(_mm("router", t, e, d))
        tk = int(t * k * cfg.capacity_factor)
        n_mats = 3 if cfg.act == "swiglu" else 2
        wls.append(_mm("expert_up", tk, f * (n_mats - 1), d))
        wls.append(_mm("expert_down", tk, d, f))
        if cfg.n_shared_experts:
            fs = cfg.d_expert * cfg.n_shared_experts
            wls.append(_mm("shared_up", t, fs * (n_mats - 1), d))
            wls.append(_mm("shared_down", t, d, fs))
    elif cfg.d_ff:
        n_mats = 3 if cfg.act == "swiglu" else 2
        wls.append(_mm("mlp_up", t, cfg.d_ff * (n_mats - 1), d))
        wls.append(_mm("mlp_down", t, d, cfg.d_ff))

    tail = [_mm("lm_head", t, cfg.vocab, d)]
    n_layers = cfg.n_layers
    return LoweredLM(workloads=_with_training(wls, training),
                     repeat=n_layers,
                     tail=_with_training(tail, training))
