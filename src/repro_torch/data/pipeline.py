"""Host-side model inputs of the port.

Only ``extra_model_inputs``, a copy of the reference's (numpy).  The
synthetic LM data (``SyntheticLM``) and the sharded loaders wait for
the training slice.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig


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
