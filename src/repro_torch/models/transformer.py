"""Transformer blocks of the port and the stack over them.

A block is an ``nn.Module`` holding the reference's block pytree as
``nn.ParameterDict``s (``norm1``, ``norm2``, ``mixer``, ``ffn``); the
stack is an ``nn.ModuleList`` run layer by layer.  The reference scans
over stacked groups of layers because ``jit`` wants one traced body;
eager PyTorch has no such need, so the layers are unrolled and a
layer's cache is its own ``{"self": KVCache}``.  This slice runs
``kind == "attn"`` blocks with a dense FFN (the dense GQA configs);
``models.model.check_ported`` refuses the rest.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L


class Block(nn.Module):
    """One decoder layer: its parameters as the reference's block
    pytree, ``parts = {"norm1": {...}, "norm2": {...}, "mixer": {...},
    "ffn": {...}}`` of tensors."""

    def __init__(self, kind: str, parts: dict):
        super().__init__()
        self.kind = kind
        for name, tensors in parts.items():
            setattr(self, name, L.param_dict(tensors))


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype) -> Block:
    d, dev = cfg.d_model, gen.device
    if kind != "attn":
        raise NotImplementedError(f"a {kind!r} block is not ported")
    return Block(kind, {"norm1": L.norm_init(d, cfg.norm, dtype, dev),
                        "norm2": L.norm_init(d, cfg.norm, dtype, dev),
                        "mixer": attn.gqa_init(gen, cfg, dtype),
                        "ffn": L.ffn_init(gen, d, cfg.d_ff, cfg.act, dtype)})


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, s_max: int,
                     dtype, device) -> dict:
    """Zero caches for decode."""
    if kind != "attn":
        raise NotImplementedError(f"a {kind!r} block's cache is not ported")
    shape = (batch, s_max, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"self": attn.KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device))}


def block_apply(block: Block, cfg: ModelConfig, x, *, positions, mode: str,
                cache: Optional[dict] = None, cache_pos=None,
                q_block: int = 1024, kv_block: int = 1024):
    """Apply one block.  Returns (x', cache'): the prompt's cache in
    prefill, the cache written in place in decode, None in train."""
    h = L.apply_norm(block.norm1, x, cfg.norm)
    if mode == "decode":
        y, c = attn.gqa_decode(block.mixer, h, cfg, cache=cache["self"],
                               cache_pos=cache_pos, positions=positions)
    else:
        y, c = attn.gqa_attention(block.mixer, h, cfg, positions=positions,
                                  mode=mode, window=cfg.local_window,
                                  q_block=q_block, kv_block=kv_block)
    x = x + y
    h = L.apply_norm(block.norm2, x, cfg.norm)
    x = x + L.apply_ffn(block.ffn, h, cfg.act)
    return x, (None if c is None else {"self": c})


def stack_caches(cfg: ModelConfig, *, batch: int, s_max: int, dtype,
                 device) -> List[dict]:
    return [init_block_cache(cfg, kind, batch, s_max, dtype, device)
            for kind in cfg.layer_kinds()]


def stack_apply(layers: nn.ModuleList, cfg: ModelConfig, x, *, mode: str,
                positions, caches=None, cache_pos=None,
                q_block: int = 1024, kv_block: int = 1024):
    """Run the stack.  Returns (x, caches'): a list of per-layer caches
    in prefill and decode, None in train."""
    new_caches = []
    for i, block in enumerate(layers):
        x, c = block_apply(block, cfg, x, positions=positions, mode=mode,
                           cache=None if caches is None else caches[i],
                           cache_pos=cache_pos, q_block=q_block,
                           kv_block=kv_block)
        new_caches.append(c)
    return x, (None if mode == "train" else new_caches)
