"""Plain PyTorch versions of the per-depth forward-sweep kernels.

The same expressions as the reference package's oracles: gather-then-add
for the arrivals, the exact min/max grouping of the Appendix-A wait
rule.  Dtypes are preserved (f64 / f32 / bf16) — no silent upcast.  The
CUDA kernels in ``sweep.py`` are held bit-equal to these.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.order import total_order_key


def arrivals_ref(tq_prev, dn, par_pos):
    """Level-d query arrival times from level d-1's.

    ``tq_prev`` — (E, L_prev) arrival times of the parent level;
    ``dn`` — (E, L) this level's downstream link terms; ``par_pos`` —
    (L,) each node's parent position inside the parent level.  Returns
    (E, L): ``tq_prev[:, par_pos] + dn``.
    """
    return tq_prev[:, par_pos] + dn


def _pick(a, b, b_wins):
    """``a``, or ``b`` where ``b_wins``, under ``jnp.maximum`` /
    ``jnp.minimum``'s rule: a NaN operand wins (``a``'s first, its bits
    kept), and otherwise the IEEE total order decides, so -0.0 < +0.0
    (``torch.maximum`` leaves the sign of a zero tie unspecified)."""
    return torch.where(torch.isnan(a), a,
                       torch.where(torch.isnan(b) | b_wins, b, a))


def nan_max(a, b):
    """``jnp.maximum(a, b)``: NaN if either is (``a``'s first), and
    +0.0 above -0.0."""
    return _pick(a, b, total_order_key(a) < total_order_key(b))


def nan_min(a, b):
    """``jnp.minimum(a, b)``: NaN if either is (``a``'s first), and
    -0.0 below +0.0."""
    return _pick(a, b, total_order_key(b) < total_order_key(a))


def wait_ref(own_ready, all_in, deadline, death=None):
    """Appendix-A send-time rule, elementwise over (E, L).

    ``s = min(max(own_ready, all_in), max(deadline, own_ready))`` — a
    peer sends when its own execution AND every child arrival are in,
    capped by its TTL deadline, but never before its own list is ready.
    The min and max follow ``jnp.minimum`` / ``jnp.maximum`` (see
    :func:`nan_max`): a NaN operand gives the first NaN in the
    expression's order, and -0.0 orders below +0.0.
    With ``death`` returns ``(s, send)``, where ``send`` is ``s`` masked
    to ``inf`` for a peer dead at its send time (the churn variant).
    """
    s = nan_min(nan_max(own_ready, all_in), nan_max(deadline, own_ready))
    if death is None:
        return s
    return s, torch.where(death >= s, s, float("inf"))
