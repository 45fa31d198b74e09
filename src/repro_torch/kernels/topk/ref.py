"""Plain PyTorch version of the local top-k kernel.

The paper's "Local Query Execution" phase: each peer scores its local
data items and keeps the k best (score, address) couples.  The CPU path
of the port runs this; the CUDA kernel in ``topk.py`` is held bit-equal
to it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.order import take_bits, total_order_key


def to_f32(scores):
    """``scores`` cast to f32 as the reference's ``astype(float32)``
    casts them: exactly, and a bf16 or f16 NaN keeps its sign and
    payload (torch's own cast of an f16 NaN gives the canonical NaN).
    The CUDA kernel widens the same way."""
    x = scores.to(torch.float32)
    if scores.dtype not in (torch.bfloat16, torch.float16):
        return x
    h = scores.view(torch.int16).to(torch.int32)
    if scores.dtype == torch.bfloat16:
        bits = h << 16
    else:
        bits = ((h & 0x8000) << 16) | 0x7F800000 | ((h & 0x3FF) << 13)
    return torch.where(torch.isnan(scores), bits.view(torch.float32), x)


def topk_ref(scores, k: int, index_offset: int = 0):
    """Top-k values and *global* indices of ``scores`` along the last axis.

    ``scores`` (..., n) in any dtype, compared as f32 (``to_f32``).
    Returns (..., k) f32 values, descending in the reference's total
    order (``kernels/order.py``), and int32 indices
    ``local + index_offset``; ties go to the lowest
    index, as in ``lax.top_k``: a stable descending sort of the
    total-order keys (``torch.topk`` leaves its tie order unspecified).
    """
    x = to_f32(scores)
    n = x.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"k={k} > n={n}" if k > n else f"k={k} < 0")
    _, pos = torch.sort(total_order_key(x), dim=-1, descending=True,
                        stable=True)
    pos = pos[..., :k]
    return take_bits(x, pos), (pos + index_offset).to(torch.int32)
