"""Plain reference of a top-k query: the k largest scores of each row and
their indices, descending, the lowest index first among equal scores (a
stable descending sort)."""
from __future__ import annotations

import torch


def topk_rows(x: torch.Tensor, k: int, block: int = 8) -> tuple:
    """(values (R, k) in x's dtype, indices (R, k) int64) of each row of
    ``x`` (R, N), sorted ``block`` rows at a time."""
    vals, idx = [], []
    for r0 in range(0, x.shape[0], block):
        v, i = torch.sort(x[r0:r0 + block], dim=-1, descending=True,
                          stable=True)
        vals.append(v[:, :k].clone())
        idx.append(i[:, :k].clone())
        del v, i
    return torch.cat(vals), torch.cat(idx)
