"""Griffin / RecurrentGemma recurrent block of the port: a temporal
convolution and the RG-LRU (arXiv:2402.19427).

RG-LRU:  a_t = exp(-c * softplus(lam) * sigmoid(W_a x_t)),
         h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Decode (S == 1) takes one step of the recurrence.  Prefill solves the
linear recurrence h_t = a_t h_{t-1} + b_t for all t at once, as the
reference's ``jax.lax.associative_scan`` does, with a log-depth
(Hillis-Steele) scan over the (a, b) pairs: ceil(log2 S) elementwise
steps, not a loop over time steps.  Its tree is not the reference's, so
its f32 rounding differs by a few ulps.

Over model ranks the RG-LRU width splits (the partition rules'
``rglru`` entries): ``w_x`` / ``w_gate`` are column blocks, ``conv_w``,
``conv_b`` and ``lam`` blocks of the width, ``w_a`` / ``w_i`` the
rank's diagonal blocks, ``w_out`` a row block whose product is summed
over the ranks, and the decode state holds the rank's width block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.mesh import copy_to_model, reduce_from_model
from repro_torch.models.layers import dense_init, split_axis, wide

_C = 8.0        # griffin's fixed recurrence sharpness constant
_N_BLOCKS = 16  # block-diagonal gate matrices


def griffin_init(gen: torch.Generator, cfg, dtype) -> dict:
    d, dev = cfg.d_model, gen.device
    lw = cfg.recurrent.lru_width or d
    cw = cfg.recurrent.conv_width
    nb = _N_BLOCKS if lw % _N_BLOCKS == 0 else 1
    bs = lw // nb

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return (w * scale).to(dtype)

    # lam so that a^c = exp(-c softplus(lam)) spans about [0.9, 0.999]
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, lw, dtype=torch.float32, device=dev)) / _C))
    return {
        "w_x": dense_init(gen, d, lw, dtype),
        "w_gate": dense_init(gen, d, lw, dtype),
        "conv_w": normal((cw, lw), cw ** -0.5),
        "conv_b": torch.zeros((lw,), dtype=dtype, device=dev),
        "w_a": normal((nb, bs, bs), bs ** -0.5),
        "w_i": normal((nb, bs, bs), bs ** -0.5),
        "lam": lam,
        "w_out": dense_init(gen, lw, d, dtype, scale=lw ** -0.5),
    }


def _block_diag(x, w):
    """x: (B, S, L) @ block-diagonal w: (nb, bs, bs) -> (B, S, L)."""
    b, s, d = x.shape
    nb = w.shape[0]
    xr = x.reshape(b, s, nb, d // nb)
    return torch.einsum("bsnl,nlm->bsnm", xr, w).reshape(b, s, d)


def _linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along
    dim 1, and the running products of a: (a_cum, h).  Hillis-Steele:
    at offset d each position t >= d composes with position t - d."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def rglru(x, a_gate, i_gate, lam, h0):
    """x, gates: (B, S, L); lam: (L,); h0: (B, L) f32.  Returns (h (B, S,
    L) in x's dtype, h_S (B, L) f32)."""
    f32 = torch.promote_types(x.dtype, torch.float32)   # as wide()
    r = torch.sigmoid(a_gate.to(f32))
    i = torch.sigmoid(i_gate.to(f32))
    log_a = -_C * F.softplus(lam)[None, None] * r              # <= 0
    a = torch.exp(log_a)
    gated = x.to(f32) * i * torch.sqrt(
        torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))

    if x.shape[1] == 1:  # decode
        h = a[:, 0] * h0 + gated[:, 0]
        return h[:, None].to(x.dtype), h

    a_cum, h = _linear_scan(a, gated)
    h = h + a_cum * h0[:, None]
    return h.to(x.dtype), h[:, -1]


def width_split(cfg):
    """(the model axis the RG-LRU width is split over, or None; this
    rank's width)."""
    lw = cfg.recurrent.lru_width or cfg.d_model
    ax = split_axis("rglru", "w_x", cfg, lw)
    if ax is None:
        return None, lw
    nb = _N_BLOCKS if lw % _N_BLOCKS == 0 else 1
    if split_axis("rglru", "w_a", cfg, nb) is None:
        raise ValueError(f"{cfg.name}: the RG-LRU width {lw} splits over "
                         f"{ax.size} model peers, its {nb} gate blocks "
                         f"do not")
    return ax, lw // ax.ranks


def apply_griffin(params, x, cfg, *, state):
    """Griffin recurrent block.  x: (B, S, D); state: (h (B, L) f32,
    conv_buf (B, cw - 1, L) f32, cast to x's dtype on use; L this
    rank's width).  Returns (y, (h_S, the last cw - 1 conv inputs in
    f32))."""
    cw = cfg.recurrent.conv_width
    h0, conv_buf = state
    ax, _ = width_split(cfg)
    x = copy_to_model(x, ax)

    xb = x @ params["w_x"]                                     # (B,S,L)
    gb = F.gelu(x @ params["w_gate"], approximate="tanh")

    # causal depthwise temporal conv of width cw over the carried buffer
    padded = torch.cat([conv_buf.to(xb.dtype), xb], dim=1)
    s = xb.shape[1]
    conv = sum(padded[:, j:j + s] * params["conv_w"][j]
               for j in range(cw)) + params["conv_b"]
    new_buf = wide(padded[:, -(cw - 1):]) if cw > 1 else conv_buf

    a_gate = _block_diag(conv, params["w_a"])
    i_gate = _block_diag(conv, params["w_i"])
    h, h_last = rglru(conv, a_gate, i_gate, params["lam"], h0)

    y = reduce_from_model((h * gb) @ params["w_out"], ax)
    return y, (h_last, new_buf)


def griffin_init_state(cfg, batch: int, device):
    """Zero (h (B, L), conv_buf (B, cw - 1, L)), both f32, L this rank's
    width."""
    r = cfg.recurrent
    _, lw = width_split(cfg)
    return (torch.zeros((batch, lw), dtype=torch.float32, device=device),
            torch.zeros((batch, r.conv_width - 1, lw), dtype=torch.float32,
                        device=device))
