"""Rotary position embeddings (standard RoPE).

Qwen2-VL's M-RoPE (``apply_mrope``) and Whisper's
``sinusoidal_embedding`` wait for the slices that port those
architectures.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int32.  Rotates in f32 and
    returns ``x``'s dtype."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (half,)
    ang = positions[..., None].float() * freqs                   # (B,S,half)
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)
