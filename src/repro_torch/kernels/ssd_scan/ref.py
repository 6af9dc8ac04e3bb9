"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan.

The port of the JAX package's `models/ssm.py` SSD functions (`segsum`,
`ssd_chunk_scan`, `ssd_chunk_scan_streaming`, `ssd_reference`) and of its
kernel oracle `kernels/ssd_scan/ref.py::ssd_scan_ref`.  They live here,
not in `models/ssm.py` (which re-exports them), so that the model can call
`ops.ssd_scan` without an import cycle.

Model layout: xh [B,T,H,P], dt [B,T,H] (post-softplus), A [H] (negative),
Bh/Ch [B,T,G,N] with H a multiple of G; -> y [B,T,H,P] without the D skip.
"""
from __future__ import annotations

import torch


def segsum(x):
    """Stable segment-sum: out[..., i, j] = sum_{j < l <= i} x[..., l].
    Lower-triangular (i >= j), -inf above diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def _expand_groups(v, h):
    """[..., G, N] -> [..., H, N], each group repeated H / G times."""
    return v.repeat_interleave(h // v.shape[-2], dim=-2)


def _chunked(xh, dt, A, q):
    """-> (xc [B,nc,Q,H,P], dtc [B,nc,Q,H], dA [B,nc,Q,H], its in-chunk
    cumulative sum)."""
    b, t, h, p = xh.shape
    assert t % q == 0, (t, q)
    nc = t // q
    dtc = dt.reshape(b, nc, q, h)
    dA = dtc * A[None, None, None, :]
    return xh.reshape(b, nc, q, h, p), dtc, dA, torch.cumsum(dA, dim=2)


def chunk_cb(Ch, Bh, chunk: int):
    """Step 1: C B^T per (batch row, chunk, group) -> [B,nc,G,Q,Q], row i
    (C's position) against column j (B's), all Q x Q entries."""
    b, t, g, n = Bh.shape
    nc = t // chunk
    return torch.einsum("bcqgn,bckgn->bcgqk",
                        Ch.reshape(b, nc, chunk, g, n),
                        Bh.reshape(b, nc, chunk, g, n))


def chunk_states(xh, dt, A, Bh, chunk: int):
    """Step 2: each chunk's own state, (B o exp(cs_last - cs) o dt)^T X per
    (batch row, chunk, head) -> [B,nc,H,N,P]."""
    h = xh.shape[2]
    b, t, g, n = Bh.shape
    xc, dtc, _, dA_cs = _chunked(xh, dt, A, chunk)
    Bex = _expand_groups(Bh.reshape(b, t // chunk, chunk, g, n), h)
    decay_out = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)     # [B,nc,Q,H]
    return torch.einsum("bcqhn,bcqh,bcqh,bcqhp->bchnp",
                        Bex, decay_out, dtc, xc)


def state_passing(states, dt, A, chunk: int):
    """Step 3: the state entering each chunk, S_0 = 0 and S_c = S_{c-1}
    exp(cs_last, c-1) + s_{c-1}, from the chunk states [B,nc,H,N,P] ->
    [B,nc,H,N,P]."""
    b, nc, h = states.shape[:3]
    dA = dt.reshape(b, nc, chunk, h) * A[None, None, None, :]
    chunk_decay = torch.exp(torch.cumsum(dA, dim=2)[:, :, -1, :])  # [B,nc,H]
    s = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    return torch.stack(prev, dim=1)


def chunk_outputs(xh, dt, A, Ch, cb, prev_states, chunk: int):
    """Step 4: y = (CB o L o dt) X + (C o exp(cs)) S_c per (batch row,
    chunk, head), L[i, j] = exp(cs[i] - cs[j]) for j <= i -> [B,T,H,P]."""
    b, t, h, p = xh.shape
    g, n = Ch.shape[2], Ch.shape[3]
    nc = t // chunk
    xc, dtc, dA, dA_cs = _chunked(xh, dt, A, chunk)
    Cex = _expand_groups(Ch.reshape(b, nc, chunk, g, n), h)
    L = torch.exp(segsum(dA.movedim(-1, 2)))               # [B,nc,H,Q,Q]
    scores = cb.repeat_interleave(h // g, dim=2)           # [B,nc,H,Q,Q]
    y_diag = torch.einsum("bchqk,bchqk,bckh,bckhp->bcqhp",
                          scores, L.to(scores.dtype), dtc, xc)
    decay_in = torch.exp(dA_cs)                            # [B,nc,Q,H]
    y_off = torch.einsum("bcqhn,bcqh,bchnp->bcqhp",
                         Cex, decay_in, prev_states)
    return (y_diag + y_off).reshape(b, t, h, p)


def ssd_chunk_scan(xh, dt, A, Bh, Ch, chunk: int):
    """Chunked SSD, all chunks at once (the kernel's oracle): the SSD block
    decomposition of arXiv:2405.21060 sec. 6-7 as its four steps."""
    assert xh.shape[1] % chunk == 0, (xh.shape[1], chunk)
    states = chunk_states(xh, dt, A, Bh, chunk)
    prev = state_passing(states, dt, A, chunk)
    return chunk_outputs(xh, dt, A, Ch, chunk_cb(Ch, Bh, chunk), prev,
                         chunk)


def ssd_chunk_scan_streaming(xh, dt, A, Bh, Ch, chunk: int):
    """Memory-lean SSD: a loop over chunks carrying the SSM state, so the
    peak temporary is one chunk's [B,H,Q,Q] block (the model's form)."""
    b, t, h, p = xh.shape
    g, n = Bh.shape[2], Bh.shape[3]
    q = chunk
    assert t % q == 0, (t, q)
    nc = t // q
    xc = xh.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    Bc = _expand_groups(Bh.reshape(b, nc, q, g, n), h)
    Cc = _expand_groups(Ch.reshape(b, nc, q, g, n), h)
    state = torch.zeros((b, h, n, p), dtype=xh.dtype, device=xh.device)
    ys = []
    for c in range(nc):
        x_i, dt_i, b_i, c_i = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        dA = dt_i * A[None, None, :]                       # [B,Q,H]
        dA_cs = torch.cumsum(dA, dim=1)
        L = torch.exp(segsum(dA.movedim(-1, 1)))           # [B,H,Q,Q]
        scores = torch.einsum("bqhn,bkhn->bhqk", c_i, b_i)
        y = torch.einsum("bhqk,bhqk,bkh,bkhp->bqhp", scores,
                         L.to(scores.dtype), dt_i, x_i)
        decay_in = torch.exp(dA_cs)                        # [B,Q,H]
        y = y + torch.einsum("bqhn,bqh,bhnp->bqhp", c_i, decay_in, state)
        total = dA_cs[:, -1, :]                            # [B,H]
        decay_out = torch.exp(total[:, None, :] - dA_cs)
        state = state * torch.exp(total)[..., None, None] + torch.einsum(
            "bqhn,bqh,bqh,bqhp->bhnp", b_i, decay_out, dt_i, x_i)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(b, t, h, p)


def ssd_reference(xh, dt, A, Bh, Ch):
    """O(T^2) attention-form oracle: y_t = sum_{s<=t} C_t^T (prod decay)
    B_s dt_s x_s."""
    h = xh.shape[2]
    Bex, Cex = _expand_groups(Bh, h), _expand_groups(Ch, h)
    dA = dt * A[None, None, :]
    L = torch.exp(segsum(dA.movedim(-1, 1)))               # [B,H,T,T]
    scores = torch.einsum("bqhn,bkhn->bhqk", Cex, Bex)
    return torch.einsum("bhqk,bhqk,bkh,bkhp->bqhp",
                        scores, L.to(scores.dtype), dt, xh)


def ssd_scan_ref(x, dt, da, b, c):
    """Quadratic attention-form SSD on the flattened layout.  x: [BH,T,P];
    dt/da: [BH,T,1]; b/c: [BH,T,N] -> [BH,T,P]."""
    l_mat = torch.exp(segsum(da[..., 0]))                  # [BH, T, T]
    l_mat = l_mat.masked_fill(~torch.isfinite(l_mat), 0.0)
    scores = torch.einsum("bqn,bkn->bqk", c.float(), b.float())
    w = scores * l_mat * dt[..., 0][:, None, :]
    return torch.einsum("bqk,bkp->bqp", w, x.float()).to(x.dtype)
