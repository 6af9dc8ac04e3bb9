"""Plain PyTorch version of the grouped expert product: one product a
group, in a loop over the groups."""
from __future__ import annotations

import torch


def grouped_mm_ref(x: torch.Tensor, w: torch.Tensor,
                   offs: torch.Tensor) -> torch.Tensor:
    """x [M, K], its rows sorted by group; w [G, K, N]; offs [G], the end
    of each group's rows (group g owns rows offs[g-1]:offs[g], offs[-1] ==
    M) -> [M, N] in x's type, rows of group g times w[g].  A group with no
    rows takes no product."""
    out = x.new_empty((x.shape[0], w.shape[2]))
    start = 0
    for g, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[g]
        start = end
    return out
