"""Top-k routed Mixture-of-Experts FFN of the port.

The router's top-k is the paper's "local query execution": each token
keeps the k best of its expert scores, with no communication.  It runs
through ``kernels/topk/ops.py::topk_with_grad``, which is ``local_topk``
(the top-k kernel on the card, its plain version ``topk_ref`` on the
CPU, with ``lax.top_k``'s order: descending, lowest index on ties;
``torch.topk``'s tie order is unspecified) with ``lax.top_k``'s
gradient, a scatter back to the winners.

Training differentiates as the reference does: a dropped (token, slot)
pair gets no gradient (the buffer's extra row, where dropped pairs land,
is never read), and the auxiliary loss's gradient flows through the
mean probability of each expert only (the fraction routed to it comes
from a one-hot of the indices).

Serving takes the reference's ``"capacity"`` route: a stable sort of the
(token, slot) pairs by expert, a static (E * C, D) buffer and batched
per-expert products, tokens beyond C = ceil(T * k / E *
capacity_factor) dropped (GShard semantics; a decoded token therefore
depends on its batch-mates, reference fault 8).  Every expert's C rows
are computed each step, as in the reference.  ``impl="ragged"`` is the
dropless grouped product (the reference's ``lax.ragged_dot``), a loop
over experts here, reached only by a direct call.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.topk import topk_with_grad
from repro_torch.models.layers import dense_init, wide


def moe_init(gen: torch.Generator, cfg, dtype) -> dict:
    """The router (D, E) in f32, the experts' ``w_gate`` / ``w_up`` (E, D,
    F) and ``w_down`` (E, F, D), and a shared expert of width F *
    ``n_shared_experts`` where the config has one."""
    e = cfg.moe
    d, f, dev = cfg.d_model, e.d_expert, gen.device

    def experts(d_in, d_out):
        w = torch.randn((e.n_experts, d_in, d_out), generator=gen,
                        dtype=torch.float32, device=dev)
        return (w * d_in ** -0.5).to(dtype)

    p = {"router": dense_init(gen, d, e.n_experts, torch.float32,
                              scale=0.02),
         "w_gate": experts(d, f), "w_up": experts(d, f),
         "w_down": experts(f, d)}
    if e.n_shared_experts:
        fs = f * e.n_shared_experts
        p["shared"] = {"w_gate": dense_init(gen, d, fs, dtype),
                       "w_up": dense_init(gen, d, fs, dtype),
                       "w_down": dense_init(gen, fs, d, dtype,
                                            scale=fs ** -0.5)}
    return p


def _router_logits(xf, router):
    """``xf`` (T, D) in f32 times the f32 router, TF32 off for this
    product, so that the card and the CPU path pick the same experts."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return wide(xf) @ router
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def apply_moe(params, x, cfg):
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, aux_loss f32 scalar).

    aux_loss is the Switch / GShard load-balance loss (mean fraction *
    mean gate mass per expert * n_experts * router_aux_coef).  The
    reference dispatches per data shard under a mesh
    (``_moe_dispatch_outside``); with one data shard that is this
    function's arithmetic (the same T = B * S and the same capacity), so
    the port has one function for both.
    """
    return _moe_local(params, x, cfg)


def _moe_local(params, x, cfg, *, impl: str = "capacity"):
    """One-shard MoE; ``impl`` is ``"capacity"`` (the serving route) or
    ``"ragged"`` (dropless, one product a non-empty expert)."""
    e = cfg.moe
    b, s, d = x.shape
    t, k, n_e = b * s, e.top_k, e.n_experts
    xf = x.reshape(t, d)

    probs = torch.softmax(_router_logits(xf, params["router"]), dim=-1)
    gate_vals, expert_ids = topk_with_grad(probs, k)          # (T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    expert_ids = expert_ids.long()

    frac = F.one_hot(expert_ids, n_e).float().mean(dim=(0, 1))
    mass = probs.mean(dim=0)
    aux = n_e * (frac * mass).sum() * e.router_aux_coef

    # dispatch: the (token, slot) pairs sorted by expert, stably, as
    # jnp.argsort sorts (drops beyond capacity follow this order)
    flat_exp = expert_ids.reshape(-1)                          # (T*k,)
    order = torch.argsort(flat_exp, stable=True)
    inv_order = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * k, device=x.device))
    tok_idx = order // k
    # jnp.bincount(length=E); torch.bincount on the card reads the
    # largest id back to the host first, a sync in every layer
    counts = torch.zeros(n_e, dtype=torch.long,
                         device=x.device).scatter_add_(
        0, flat_exp, torch.ones_like(flat_exp))

    if impl == "ragged":
        xin = xf[tok_idx]                                      # (T*k, D)
        yo = torch.empty_like(xin)
        start = 0
        for ex, n in enumerate(counts.tolist()):
            if n:
                rows = xin[start:start + n]
                h = F.silu(rows @ params["w_gate"][ex]) * (
                    rows @ params["w_up"][ex])
                yo[start:start + n] = h @ params["w_down"][ex]
            start += n
        yo = yo[inv_order].reshape(t, k, d)
    elif impl == "capacity":
        cap = int(math.ceil(t * k / n_e * e.capacity_factor))
        sorted_exp = flat_exp[order]
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(t * k, device=x.device) - starts[sorted_exp]
        slot = torch.where(rank < cap, sorted_exp * cap + rank, n_e * cap)
        # one row more than E * C: the dropped pairs land there, unread
        buf = torch.zeros((n_e * cap + 1, d), dtype=xf.dtype,
                          device=x.device)
        buf[slot] = xf[tok_idx]
        bufe = buf[:n_e * cap].view(n_e, cap, d)
        h = F.silu(torch.bmm(bufe, params["w_gate"])) * torch.bmm(
            bufe, params["w_up"])
        y_buf = torch.bmm(h, params["w_down"]).reshape(n_e * cap, d)
        slot_of_flat = slot[inv_order]
        kept = (slot_of_flat < n_e * cap)[:, None]
        y_flat = y_buf[torch.clamp_max(slot_of_flat, n_e * cap - 1)]
        yo = torch.where(kept, y_flat, 0).reshape(t, k, d)
    else:
        raise ValueError(f"unknown MoE impl {impl!r}")
    y = (yo * gate_vals[..., None].to(yo.dtype)).sum(dim=1)

    if e.n_shared_experts:
        sp = params["shared"]
        hs = F.silu(xf @ sp["w_gate"]) * (xf @ sp["w_up"])
        y = y + hs @ sp["w_down"]
    return y.reshape(b, s, d).to(x.dtype), aux
