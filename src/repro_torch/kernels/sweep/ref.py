"""Plain PyTorch versions of the per-depth forward-sweep kernels.

The same expressions as the reference package's oracles: gather-then-add
for the arrivals, the exact min/max grouping of the Appendix-A wait
rule.  Dtypes are preserved (f64 / f32 / bf16) — no silent upcast.  The
CUDA kernels in ``sweep.py`` are held bit-equal to these.
"""
from __future__ import annotations

import torch


def arrivals_ref(tq_prev, dn, par_pos):
    """Level-d query arrival times from level d-1's.

    ``tq_prev`` — (E, L_prev) arrival times of the parent level;
    ``dn`` — (E, L) this level's downstream link terms; ``par_pos`` —
    (L,) each node's parent position inside the parent level.  Returns
    (E, L): ``tq_prev[:, par_pos] + dn``.
    """
    return tq_prev[:, par_pos] + dn


def wait_ref(own_ready, all_in, deadline, death=None):
    """Appendix-A send-time rule, elementwise over (E, L).

    ``s = min(max(own_ready, all_in), max(deadline, own_ready))`` — a
    peer sends when its own execution AND every child arrival are in,
    capped by its TTL deadline, but never before its own list is ready.
    With ``death`` returns ``(s, send)``, where ``send`` is ``s`` masked
    to ``inf`` for a peer dead at its send time (the churn variant).
    """
    s = torch.minimum(torch.maximum(own_ready, all_in),
                      torch.maximum(deadline, own_ready))
    if death is None:
        return s
    return s, torch.where(death >= s, s, float("inf"))
