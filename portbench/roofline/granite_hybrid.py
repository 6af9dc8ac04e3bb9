"""The work of one `forward(tokens [B, S], logits_mode="last")` of a
Granite 4.0-H hybrid (`reference/granite_hybrid.py`): two operations per
weight and token for every weight product, the routed experts counted
only for the `top_k` a token takes; the router and the shared expert
every token; each Mamba-2 layer's in/out projections, its depthwise
conv's multiply-adds and its SSD scan (`roofline.ssd_work`); each
attention layer's projections and causal attention
(`roofline.flash_work`); the head at the last position only.

`grouped_work` counts the routed experts' grouped products, which
`metrics/moe_roofline.prefill.py` holds their kernels' time to.
"""
from __future__ import annotations

from portbench.roofline import (PEAK_BF16_FLOP_PER_S, bound_s, flash_work,
                                ssd_work)


def grouped_work(tokens: int, k: int, d: int, f: int, e: int,
                 esize: int = 2):
    """-> (operations, bytes) of one layer's routed SwiGLU experts as three
    grouped products over the tokens x k rows: gate and up [T k, d] x [d,
    f], down [T k, f] x [f, d] for the expert each row goes to.  Each
    product reads its rows and its E experts' weights once and writes its
    output once, at `esize` bytes an element."""
    rows = tokens * k
    flops = 3 * 2 * rows * d * f
    nbytes = esize * (3 * rows * d + 3 * e * d * f + 3 * rows * f)
    return flops, nbytes


def grouped_bound_s(tokens, k, d, f, e):
    """The least time of one layer's grouped expert products in bf16, at
    the bf16 tensor-core peak or their bytes, whichever is larger."""
    return bound_s(*grouped_work(tokens, k, d, f, e, esize=2),
                   PEAK_BF16_FLOP_PER_S)


def work(m: dict, b: int, s: int) -> dict:
    d, t = m["d_model"], b * s
    di = m["expand"] * d
    g, n, p = m["ssm_ngroups"], m["d_state"], m["ssm_headdim"]
    nh = di // p
    h, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    e, k, f = m["n_experts"], m["top_k"], m["d_expert"]
    mamba = 2 * d * (2 * di + 2 * g * n + nh) + 2 * di * d \
        + 2 * m["d_conv"] * (di + 2 * g * n)
    attn = 2 * d * hd * (h + 2 * hkv) + 2 * h * hd * d
    moe = 2 * d * e + k * 3 * 2 * d * f + 3 * 2 * d * m["d_shared"]
    scan = (b, s, nh, p, g, n, m["chunk"])
    heads = (b, s, h, hkv, hd)
    kinds = m["layer_types"]
    n_attn = kinds.count("attention")
    n_mamba = len(kinds) - n_attn
    flops = len(kinds) * t * moe \
        + n_mamba * (t * mamba + ssd_work(*scan)[0]) \
        + n_attn * (t * attn + flash_work(*heads)[0]) \
        + 2 * b * d * m["vocab"]
    return {"flops": flops, "flash": [heads] * n_attn, "ssd": [scan] * n_mamba,
            "moe": [(t, k, d, f, e)] * len(kinds)}
