"""Rotary position embeddings: standard RoPE, Qwen2-VL's M-RoPE, and
Whisper's sinusoidal table."""
from __future__ import annotations

import math

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the halves of ``x`` (B, S, H, Dh) by the angles ``ang``
    (B, S, Dh // 2) in f32 (an f64 ``x`` in f64), returning ``x``'s
    dtype."""
    half = x.shape[-1] // 2
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    wide = torch.promote_types(x.dtype, torch.float32)
    xf1, xf2 = x[..., :half].to(wide), x[..., half:].to(wide)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int32.  Rotates in f32 and
    returns ``x``'s dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (half,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: (B, S, H, Dh); positions3: (3, B, S) (t, h, w) position streams;
    sections: per-stream frequency-section sizes summing to Dh // 2.
    Frequency j is driven by stream ``sec_id[j]``; for text tokens all
    three streams are equal and M-RoPE == RoPE.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"apply_mrope: sections {sections} do not sum "
                         f"to {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (half,)
    sec_id = torch.repeat_interleave(                            # (half,)
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device), output_size=half)
    ang = positions3.float()[sec_id]                             # (half,B,S)
    return _rotate(x, ang.permute(1, 2, 0) * freqs)


def sinusoidal_embedding(seq_len: int, d: int, dtype,
                         device=None) -> torch.Tensor:
    """Whisper-style sinusoidal position table (seq_len, d), computed,
    not learned: ``[sin(p * f), cos(p * f)]`` with ``f_j = exp(-ln(1e4)
    * j / max(d/2 - 1, 1))``.  The frequencies are computed on the host
    and moved to ``device``: at 1,500 positions one ulp of ``exp`` is
    2e-4 of an angle, so the card's ``exp`` would move the table."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32)
                      / max(half - 1, 1)).to(device)
    ang = (torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
           * freqs[None])
    return torch.cat([ang.sin(), ang.cos()], dim=-1).to(dtype)
