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

Over model ranks, where the experts divide the model size, the experts
run expert-parallel as in the reference (``src/repro/models/moe.py``):
every model rank routes and dispatches the same tokens (the router's
top-k included), keeps its ``E / m`` experts' rows of the buffer
(``slice_to_model``), runs its experts' products on its weight blocks,
and the ranks' outputs are all-gathered once a layer
(``gather_from_model``) before the combine.  The shared experts are an
FFN split over the model ranks (``layers.apply_ffn``).  Experts that do
not divide stay whole on every rank, as the rules leave them.

The capacity route's four parts are spans (``runtime/spans.py``):
``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.mesh import gather_from_model, slice_to_model
from repro_torch.kernels.topk import topk_with_grad
from repro_torch.models import layers as L
from repro_torch.models.layers import dense_init, wide
from repro_torch.runtime.spans import span


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
    mean gate mass per expert * n_experts * router_aux_coef).

    Under a mesh with data axes (``layers.use_mesh``), the reference
    dispatches each data shard alone (``_moe_dispatch_outside``) when
    the batch divides into them: each shard's capacity comes from its
    own tokens, and the auxiliary loss is the mean over shards.  This
    process holds ``layers.local_batch_shards()`` of them: every data
    peer on one process, one a rank where each rank holds one (its
    rows are then the shard).  Without a mesh, or where the batch does
    not divide, the batch is one shard.
    """
    shards = L.local_batch_shards()
    if x.shape[0] % shards:
        shards = 1
    return _moe_dispatch_outside(params, x, cfg, shards)


def _route(params, xf, cfg, shards: int):
    """The router over the (T, D) tokens ``xf``: (gate values (T, k),
    normalised, expert ids (T, k) int64, aux loss): the aux loss of each
    of ``shards`` contiguous blocks of T / shards tokens, then their
    mean (the reference's ``pmean``)."""
    e = cfg.moe
    k, n_e = e.top_k, e.n_experts
    probs = torch.softmax(_router_logits(xf, params["router"]), dim=-1)
    gate_vals, expert_ids = topk_with_grad(probs, k)          # (T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    expert_ids = expert_ids.long()
    t_l = xf.shape[0] // shards
    # one_hot as a comparison: F.one_hot takes another route on the card
    # than on fake tensors, and the dry run's trace must be the card's
    experts = torch.arange(n_e, device=expert_ids.device)
    frac = (expert_ids.view(shards, t_l, k, 1) == experts).float().mean(
        dim=(1, 2))                                           # (l, E)
    mass = probs.view(shards, t_l, n_e).mean(dim=1)
    aux = (n_e * (frac * mass).sum(dim=-1) * e.router_aux_coef).mean()
    return gate_vals, expert_ids, aux


def _combine(params, xf, yo, gate_vals, cfg, x):
    """The experts' outputs ``yo`` (T, k, D) weighted by their gates,
    plus the shared expert where the config has one, in x's shape and
    dtype."""
    y = (yo * gate_vals[..., None].to(yo.dtype)).sum(dim=1)
    if cfg.moe.n_shared_experts:
        y = y + L.apply_ffn(params["shared"], xf, "swiglu", cfg,
                            cfg.moe.d_expert * cfg.moe.n_shared_experts)
    return y.reshape(x.shape).to(x.dtype)


def _moe_dispatch_outside(params, x, cfg, shards: int = 1):
    """The capacity route, per data shard as the reference's
    ``_moe_dispatch_outside``: ``shards`` contiguous blocks of B /
    shards rows, each dispatched alone with capacity C = ceil(T_local *
    k / E * capacity_factor), T_local its tokens.  In each shard the
    (token, slot) pairs are sorted by expert, stably, as ``jnp.argsort``
    sorts (drops beyond capacity follow this order).  The router and
    its top-k run once over every token (both are row by row), and the
    experts' products once over the (E, shards * C, D) buffer, shard
    j's C rows of expert e at ``e * shards * C + j * C``, the
    reference's layout; one row more holds the dropped pairs, unread."""
    e = cfg.moe
    b, s, d = x.shape
    t, k, n_e = b * s, e.top_k, e.n_experts
    t_l = (b // shards) * s
    cap = int(math.ceil(t_l * k / n_e * e.capacity_factor))
    xf = x.reshape(t, d)
    dev = x.device
    with span("moe.route"):
        gate_vals, expert_ids, aux = _route(params, xf, cfg, shards)

    with span("moe.dispatch"):
        flat_exp = expert_ids.view(shards, t_l * k)
        order = torch.argsort(flat_exp, dim=1, stable=True)
        pos = torch.arange(t_l * k, device=dev).expand(shards, -1)
        inv_order = torch.empty_like(order).scatter_(1, order, pos)
        first = torch.arange(shards, device=dev)[:, None]
        tok_idx = order // k + first * t_l
        # jnp.bincount(length=E); torch.bincount on the card reads the
        # largest id back to the host first, a sync in every layer
        counts = torch.zeros((shards, n_e), dtype=torch.long,
                             device=dev).scatter_add_(
            1, flat_exp, torch.ones_like(flat_exp))
        sorted_exp = torch.gather(flat_exp, 1, order)
        starts = torch.cumsum(counts, 1) - counts
        rank = pos - torch.gather(starts, 1, sorted_exp)
        rows = n_e * shards * cap
        slot = torch.where(rank < cap,
                           sorted_exp * (shards * cap) + first * cap + rank,
                           rows)
        buf = torch.zeros((rows + 1, d), dtype=xf.dtype, device=dev)
        buf[slot.reshape(-1)] = xf[tok_idx.reshape(-1)]
        bufe = buf[:rows].view(n_e, shards * cap, d)
    with span("moe.experts"):
        ax = L.split_axis("moe", "w_up", cfg, n_e)
        bufe = slice_to_model(bufe, ax, 0)         # this rank's experts
        h = F.silu(torch.bmm(bufe, params["w_gate"])) * torch.bmm(
            bufe, params["w_up"])
        y_buf = gather_from_model(torch.bmm(h, params["w_down"]), ax,
                                  0).reshape(rows, d)
    with span("moe.combine"):
        slot_of_flat = torch.gather(slot, 1, inv_order).reshape(-1)
        kept = (slot_of_flat < rows)[:, None]
        y_flat = y_buf[torch.clamp_max(slot_of_flat, rows - 1)]
        yo = torch.where(kept, y_flat, 0).reshape(t, k, d)
        return _combine(params, xf, yo, gate_vals, cfg, x), aux


def _moe_local(params, x, cfg, *, impl: str = "capacity"):
    """One-shard MoE; ``impl`` is ``"capacity"`` (the serving route,
    :func:`_moe_dispatch_outside` over one shard) or ``"ragged"``
    (dropless, one product a non-empty expert)."""
    if impl == "capacity":
        return _moe_dispatch_outside(params, x, cfg)
    if impl != "ragged":
        raise ValueError(f"unknown MoE impl {impl!r}")
    e = cfg.moe
    b, s, d = x.shape
    t, k, n_e = b * s, e.top_k, e.n_experts
    xf = x.reshape(t, d)
    gate_vals, expert_ids, aux = _route(params, xf, cfg, 1)
    flat_exp = expert_ids.reshape(-1)                          # (T*k,)
    order = torch.argsort(flat_exp, stable=True)
    inv_order = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * k, device=x.device))
    counts = torch.zeros(n_e, dtype=torch.long,
                         device=x.device).scatter_add_(
        0, flat_exp, torch.ones_like(flat_exp))
    xin = xf[order // k]                                       # (T*k, D)
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
    return _combine(params, xf, yo, gate_vals, cfg, x), aux
