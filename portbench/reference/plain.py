"""Plain float32 building blocks of the benchmark's reference models.

Written for the benchmark from the published descriptions, not copied from
the program: it imports neither the program (`repro_torch`) nor the JAX
package, and takes nothing the program has made.  Every product runs in
float32 with TF32 off (`float32_exact`), so the reference is the answer the
bf16 program approximates.

`Products` is where the precision of the weight products is chosen: the
reference multiplies in float32; the benchmark's control (`Products("fp8")`)
rounds both operands of every weight product to float8 e4m3 with one scale a
tensor, the step below bf16 that a later change might be tempted to take.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0            # largest finite float8_e4m3fn


@contextlib.contextmanager
def float32_exact():
    """Products in true float32 (TF32 off for cuBLAS and cuDNN) inside the
    block; the previous settings come back after it."""
    mm, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 with one scale for the whole tensor (its
    largest magnitude maps to 448), returned in float32."""
    scale = FP8_MAX / t.abs().amax().clamp_min(1e-12)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class Products:
    """x [..., k] @ w [k, n] for the weight products, in float32
    ("float32") or with both operands rounded to float8 e4m3 ("fp8")."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.precision = precision

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.float(), w.float()
        if self.precision == "fp8":
            x, w = fp8_round(x), fp8_round(w)
        return x @ w


def rms_norm(x, weight, eps: float):
    """x / sqrt(mean(x^2) + eps) * weight, in float32."""
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * weight.float()


def rope(x, theta: float):
    """Rotary position embedding of x [B, S, H, D] at positions 0..S-1,
    the two halves of D rotated as pairs (x_i, x_{i + D/2}); angles in
    float64, then float32."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] \
        * inv[None, :]
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, window: int = 0):
    """softmax(q k^T / sqrt(D), causal) v for q [B, S, H, D] and k, v
    [B, S, Hkv, D] (query head h reads KV head h // (H / Hkv)); with a
    `window`, position i sees only keys j with i - j < window.  One batch
    row at a time, all heads at once, float32."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    if window:
        mask = mask.triu(1 - window)
    out = torch.empty_like(q)
    for i in range(b):
        qi = q[i].transpose(0, 1)                               # [H, S, D]
        ki = k[i].transpose(0, 1).repeat_interleave(group, 0)
        vi = v[i].transpose(0, 1).repeat_interleave(group, 0)
        scores = (qi @ ki.transpose(1, 2)) / math.sqrt(d)
        scores = scores.masked_fill(~mask, float("-inf"))
        out[i] = (torch.softmax(scores, dim=-1) @ vi).transpose(0, 1)
    return out


def segsum(a):
    """out[..., i, j] = a[..., j+1] + ... + a[..., i] for j <= i, -inf above
    the diagonal (exp of it is the decay from position j to i)."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones((t, t), dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~keep, float("-inf"))


def ssd(x, dt, a, bm, cm, chunk: int):
    """The SSD (state-space duality) scan of Mamba-2 [arXiv:2405.21060,
    sec. 6-7, the minimal chunked listing], float32:

        h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t h_t

    x [B, T, H, P], dt [B, T, H] (after softplus), a [H] (negative),
    bm/cm [B, T, G, N] (head h reads group h // (H / G)); state 0 before
    the first position.  -> y [B, T, H, P] (no D skip)."""
    b, t, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    nc, q = t // chunk, chunk
    if nc * q != t:
        raise ValueError(f"T {t} is not a multiple of the chunk {chunk}")
    xd = (x * dt[..., None]).reshape(b, nc, q, h, p)
    da = (dt * a).reshape(b, nc, q, h).permute(0, 3, 1, 2)   # [B, H, c, q]
    cs = torch.cumsum(da, dim=-1)
    bh = bm.repeat_interleave(h // g, dim=2).reshape(b, nc, q, h, n)
    ch = cm.repeat_interleave(h // g, dim=2).reshape(b, nc, q, h, n)
    # within each chunk: (C B^T o decay) (dt x)
    cb = torch.einsum("bclhn,bcshn->bchls", ch, bh)
    decay = torch.exp(segsum(da)).permute(0, 2, 1, 3, 4)     # [B, c, H, l, s]
    y = torch.einsum("bchls,bcshp->bclhp", cb * decay, xd)
    # each chunk's own end state, then the state entering each chunk
    to_end = torch.exp(cs[..., -1:] - cs)                     # [B, H, c, q]
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", bh, to_end, xd)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(cs[..., -1], (1, 0))))
    entering = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", ch, entering,
                         torch.exp(cs))
    return y.reshape(b, t, h, p)
