"""AdamW + cosine schedule + global-norm clipping, without
``torch.optim``: plain functions over the parameters of an ``LM``, in
the reference's arithmetic (``src/repro/optim/adamw.py``).

The state (:class:`AdamWState`) holds an int32 step and f32 moments
``m`` and ``v``, one a parameter, keyed by the parameter's name in
``LM.named_parameters()``.  :func:`adamw_update` updates the parameters
and the moments in place, as the reference's train step donates them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor                  # () int32
    m: Dict[str, torch.Tensor]          # f32, a parameter each
    v: Dict[str, torch.Tensor]


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up then a cosine decay to ``min_lr_ratio``, in f32 as
    the reference computes it.  ``step``: an int or an int tensor."""
    step = (step.to(torch.float32) if torch.is_tensor(step)
            else torch.tensor(float(step), dtype=torch.float32))
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def decayed(params: nn.Module, model_cfg) -> Dict[str, bool]:
    """Which parameters weight decay applies to: those whose leaf in the
    reference's parameter tree has ``ndim >= 2``
    (``src/repro/optim/adamw.py:72``, ``if p.ndim >= 2``), as the
    reference decides it, for parity (reference fault 9).

    The reference stacks the layers of each scanned group
    (``src/repro/models/transformer.py:188-205``, ``jax.vmap`` over the
    groups), so a stacked layer's leaf has one dim more than the port's:
    its norms and biases are 2-D there and decayed.  The port keeps one
    block a layer, so its leaf is decayed where ``ndim >= 2``, or where
    ``ndim >= 1`` in a layer the reference stacks.  Layer ``i`` of a
    stack of ``n`` layers with a pattern of length ``g`` is stacked when
    ``i < (n // g) * g``: the decoder's layers (``model_cfg``'s
    ``mixer_pattern``) and every encoder layer (pattern ``("attn",)``).
    The remainder layers, ``norm_f``, ``enc.norm_f`` and the top-level
    tables are not stacked."""
    glen = len(model_cfg.mixer_pattern)
    n_dec = len(params.layers) // glen * glen
    out = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            stacked = int(parts[1]) < n_dec
        else:
            stacked = parts[:2] == ["enc", "layers"]
        out[name] = p.ndim + int(stacked) >= 2
    return out


def adamw_init(params: nn.Module, cfg: AdamWConfig) -> AdamWState:
    """Zero f32 moments beside each parameter, on its device; step 0."""
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.named_parameters()}
    dev = next(iter(zeros.values())).device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros,
                      {n: z.clone() for n, z in zeros.items()})


def global_norm(tensors, *, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32.

    Over a mesh whose axes span ranks, ``tensors`` is ``{name: this
    rank's block}`` and ``specs`` their specs: each rank sums the
    squares of the blocks it counts (a leaf replicated over a rank axis
    is counted at coordinate 0 of that axis only, so every element
    once), and the partial sums are summed over each rank axis in turn
    (``optim/sharding.py::psum_axes``), so every rank holds the same
    bits."""
    if mesh is None or not mesh.multi_rank:
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in tensors))
    from repro_torch.optim.sharding import counted_here, psum_axes
    part = None
    for name, x in tensors.items():
        if counted_here(specs[name], mesh):
            sq = torch.sum(torch.square(x.to(torch.float32)))
            part = sq if part is None else part + sq
    if part is None:
        part = torch.zeros((), dtype=torch.float32, device=mesh.device)
    return torch.sqrt(psum_axes(part, mesh, mesh.axis_names))


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], state: AdamWState,
                 params: nn.Module, cfg: AdamWConfig,
                 decay: Dict[str, bool], *, mesh=None, specs=None):
    """One AdamW step of ``params`` (updated in place) from ``grads``
    (name -> gradient, any float dtype), clipped by their global norm;
    ``decay`` is :func:`decayed`'s map.  Returns (params, the new state,
    whose moments are ``state``'s updated in place, {"grad_norm",
    "lr"}): each parameter updated in f32 and cast back to its dtype.
    Over ranks (``mesh``, ``specs``), the parameters, gradients and
    moments are this rank's blocks, and the norm is
    :func:`global_norm`'s over the group."""
    step = state.step + 1
    gnorm = global_norm(grads if mesh is not None and mesh.multi_rank
                        else grads.values(), mesh=mesh, specs=specs)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                           1.0)
    lr = cosine_lr(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1.0 - torch.pow(cfg.b2, step.to(torch.float32))
    for name, p in params.named_parameters():
        m, v = state.m[name], state.v[name]
        g = grads[name].to(torch.float32) * clip
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        pf = p.to(torch.float32)
        if decay[name]:
            delta = delta + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
        m.copy_(m2)
        v.copy_(v2)
    return params, AdamWState(step, state.m, state.v), {
        "grad_norm": gnorm, "lr": lr}
