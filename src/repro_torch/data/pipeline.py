"""Host-side model inputs of the port: the deterministic synthetic token
pipeline (``SyntheticLM``, numpy, a copy of the reference's, so that its
batches are the reference's bits), ``extra_model_inputs`` (copied) and
``device_put_batch``.

Real deployments swap ``SyntheticLM`` for a file-backed source.
Sequences are Zipf-ish token draws with a repeated-ngram structure so
the ~100M-param example can visibly learn (loss drops well below uniform
entropy within a few hundred steps).  The reference's sharded loader
(``make_batch_specs``) waits for the multi-rank slice; on one device
:func:`device_put_batch` moves a batch to an explicit device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic, restartable synthetic LM data.

    Each sequence: a random "motif" of ``motif_len`` tokens repeated with
    noise — next-token prediction is learnable (copy task) but not trivial.
    """
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 32
    noise: float = 0.05
    step: int = 0                      # restart cursor (checkpointable)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        b, s, v = self.global_batch, self.seq_len, self.vocab_size
        motifs = rng.integers(0, v, (b, self.motif_len))
        reps = -(-s // self.motif_len) + 1
        toks = np.tile(motifs, (1, reps))[:, :s + 1]
        mask = rng.random((b, s + 1)) < self.noise
        toks = np.where(mask, rng.integers(0, v, (b, s + 1)), toks)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.batch_at(self.step)
            self.step += 1


def extra_model_inputs(cfg: ModelConfig, batch_np: dict, *, seed: int = 0,
                       n_vis: int = 256) -> dict:
    """Stub modality frontends: frame/patch embeddings per the assignment."""
    b = batch_np["tokens"].shape[0]
    rng = np.random.default_rng(seed)
    out = dict(batch_np)
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections is not None:
        nv = min(n_vis, batch_np["tokens"].shape[1])
        out["vision_embeds"] = rng.standard_normal(
            (b, nv, cfg.d_model)).astype(np.float32)
    return out


def device_put_batch(batch_np: dict, device) -> dict:
    """The batch's numpy arrays as tensors on ``device`` (dtypes kept),
    in place of the reference's put against the mesh's shardings."""
    return {k: torch.from_numpy(np.asarray(a)).to(device)
            for k, a in batch_np.items()}
