"""Host-side model inputs of the port: the deterministic synthetic token
pipeline (``SyntheticLM``, numpy, a copy of the reference's, so that its
batches are the reference's bits), ``extra_model_inputs`` (copied) and
``device_put_batch``.

Real deployments swap ``SyntheticLM`` for a file-backed source.
Sequences are Zipf-ish token draws with a repeated-ngram structure so
the ~100M-param example can visibly learn (loss drops well below uniform
entropy within a few hundred steps).  :func:`device_put_batch` moves a
batch to an explicit device, or gives a rank its rows of it over a mesh
(:func:`make_batch_specs`).
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


def make_batch_specs(batch: dict, mesh) -> dict:
    """Specs of the batch's leaves: the batch dim over the data axes,
    the rest replicated (``optim/sharding.py::input_specs_pytree``)."""
    from repro_torch.optim.sharding import input_specs_pytree
    return input_specs_pytree(batch, mesh)


def device_put_batch(batch_np: dict, where, *, microbatches: int = 1
                     ) -> dict:
    """The batch's numpy arrays as tensors (dtypes kept) on ``where``: a
    device, or a :class:`~repro_torch.core.mesh.Mesh`, whose device gets
    this rank's rows of every leaf whose batch dim
    :func:`make_batch_specs` shards (on one process, every row).

    With ``microbatches`` > 1 the rows follow the reference's step,
    which splits the global batch B into (microbatches, B /
    microbatches) first and then shards each microbatch's rows over the
    data axes (``src/repro/runtime/steps.py:56-61``): data block j of
    microbatch i is global rows ``i * B / mb + j * B / (mb * R)``
    onward, R the data blocks.  This rank gets its block of each
    microbatch, microbatch-major, so that the train step's own split
    into ``microbatches`` gives microbatch i its rows."""
    from repro_torch.core.mesh import Mesh
    if not isinstance(where, Mesh):
        return {k: torch.from_numpy(np.asarray(a)).to(where)
                for k, a in batch_np.items()}
    from repro_torch.optim.sharding import shard_leaf
    mesh = where
    specs = make_batch_specs(batch_np, mesh)
    out = {}
    for k, a in batch_np.items():
        t = torch.from_numpy(np.asarray(a))
        entry = specs[k][0] if specs[k] else None
        if entry is not None:
            mb = microbatches
            if t.shape[0] % mb:
                raise ValueError(f"batch of {t.shape[0]} rows does not "
                                 f"split into {mb} microbatches")
            split = t.reshape((mb, t.shape[0] // mb) + tuple(t.shape[1:]))
            split = shard_leaf(split, (None, entry), mesh)
            t = split.reshape((-1,) + tuple(t.shape[1:]))
        out[k] = t.to(mesh.device)
    return out
