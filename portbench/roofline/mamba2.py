"""The work of one `forward(tokens [B, T], logits_mode="last")` of a
Mamba-2 model (`reference/mamba2.py`): two operations per weight and token
for in_proj and out_proj, the depthwise conv's multiply-adds, each layer's
SSD scan (`roofline.ssd_work`), and the head at the last position only."""
from __future__ import annotations

from portbench.roofline import ssd_work


def work(m: dict, b: int, t: int) -> dict:
    d = m["d_model"]
    di = m["expand"] * d
    g, n, p = m["ssm_ngroups"], m["d_state"], m["ssm_headdim"]
    nh = di // p
    per_token = 2 * d * (2 * di + 2 * g * n + nh) + 2 * di * d \
        + 2 * m["d_conv"] * (di + 2 * g * n)
    scan = (b, t, nh, p, g, n, m["chunk"])
    flops = m["n_layers"] * (b * t * per_token + ssd_work(*scan)[0]) \
        + 2 * b * d * m["vocab"]
    return {"flops": flops, "flash": [], "ssd": [scan] * m["n_layers"]}
