"""Score-lists: the paper's unit of communication.

A score-list is a fixed-size list of k (score, address) couples, descending
by score: (f32 values, int32 global indices) tensors whose last axis is k.
``ENTRY_BYTES`` mirrors the paper's L=10 analysis (we use 4+4).  A copy of
the reference's ``repro/core/scorelist.py``.
"""
from __future__ import annotations

import torch

ENTRY_BYTES = 8  # f32 score + i32 global index (paper: 4 B score + 6 B addr)


def empty_scorelist(shape_prefix: tuple, k: int, device=None):
    """An all-(-inf) score-list — the identity element of merge."""
    vals = torch.full(shape_prefix + (k,), float("-inf"),
                      dtype=torch.float32, device=device)
    idx = torch.full(shape_prefix + (k,), -1, dtype=torch.int32,
                     device=device)
    return vals, idx


def scorelist_bytes(k: int, n_lists: int = 1) -> int:
    """b = k * L * n  (paper §3.2: b_bw = k*L*(|P_Q|-1))."""
    return k * ENTRY_BYTES * n_lists
