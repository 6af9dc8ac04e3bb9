"""The work of one `forward(tokens [B, S], logits_mode="last")` of a dense
decoder with grouped-query attention (`reference/dense.py`): the
forward-only form of the training count `tokens x (6N + 12 L H hd S)`,
two operations per weight and token for every weight product, causal
attention's two products a layer, and the head at the last position only."""
from __future__ import annotations

from portbench.roofline import flash_work


def work(m: dict, b: int, s: int) -> dict:
    d, hd, h, hkv = m["d_model"], m["head_dim"], m["n_heads"], m["n_kv_heads"]
    mlp = (3 if m["act"] == "swiglu" else 2) * 2 * d * m["d_ff"]
    per_token = 2 * d * hd * (h + 2 * hkv) + 2 * h * hd * d + mlp
    attn = (b, s, h, hkv, hd)
    flops = m["n_layers"] * (b * s * per_token + flash_work(*attn)[0]) \
        + 2 * b * d * m["vocab"]
    return {"flops": flops, "flash": [attn] * m["n_layers"], "ssd": []}
