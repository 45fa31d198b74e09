"""Training tokens: a frozen copy of the arithmetic of the port's
``data/pipeline.py::SyntheticLM.batch_at``.

Each sequence is a random motif of ``motif_len`` ids repeated with a
share ``noise`` of ids drawn anew, so next-token prediction has
something to learn.  Step ``step`` of seed ``seed`` is the same batch on
every machine (numpy's ``default_rng((seed, step))``).
"""
from __future__ import annotations

import numpy as np


def batch_at(seed: int, step: int, *, batch: int, seq: int, vocab: int,
             motif_len: int = 32, noise: float = 0.05) -> dict:
    """{"tokens", "labels"}: (batch, seq) int32, labels the tokens
    shifted by one."""
    rng = np.random.default_rng((seed, step))
    motifs = rng.integers(0, vocab, (batch, motif_len))
    reps = -(-seq // motif_len) + 1
    toks = np.tile(motifs, (1, reps))[:, :seq + 1]
    mask = rng.random((batch, seq + 1)) < noise
    toks = np.where(mask, rng.integers(0, vocab, (batch, seq + 1)), toks)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
