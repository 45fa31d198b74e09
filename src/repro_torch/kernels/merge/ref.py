"""Plain PyTorch version of the score-list merge kernel.

The paper's Merge-and-Backward phase: a peer merges the k-lists received
from its children with its own local k-list and keeps the k best couples.
The CPU path of the port runs this; the CUDA kernel in ``merge.py`` is
held bit-equal to it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.order import take_bits, total_order_key


def merge_ref(vals_a, idx_a, vals_b, idx_b, k: Optional[int] = None,
              valid_a=None, valid_b=None):
    """Merge two descending (vals, idx) k-lists along the last axis.

    Returns the top-k of the union, descending in the reference's total
    order (``kernels/order.py``: +0.0 ranks above -0.0, NaNs at the
    ends).  Ties are broken in favour of list ``a`` then lower position:
    a stable descending sort of the concatenation ``a ++ b`` on the
    total-order key (``torch.topk`` leaves its tie order unspecified, so
    it is not used).

    ``valid_a`` / ``valid_b``: optional boolean row masks over the
    leading axes — an invalid list contributes ``-inf`` values.
    """
    if k is None:
        k = vals_a.shape[-1]
    if valid_a is not None:
        vals_a = torch.where(valid_a[..., None], vals_a, float("-inf"))
    if valid_b is not None:
        vals_b = torch.where(valid_b[..., None], vals_b, float("-inf"))
    # float lists merge in their OWN dtype (f64 / f32 / bf16 — no silent
    # upcast); non-float and f16 inputs compute in float32
    dt = torch.result_type(vals_a, vals_b)
    if not dt.is_floating_point or dt == torch.float16:
        dt = torch.promote_types(dt, torch.float32)
    v = torch.cat([vals_a, vals_b], dim=-1).to(dt)
    i = torch.cat([idx_a, idx_b], dim=-1)
    _, pos = torch.sort(total_order_key(v), dim=-1, descending=True,
                        stable=True)
    pos = pos[..., :k]
    return take_bits(v, pos), take_bits(i, pos).to(torch.int32)
