"""Public entry of the local top-k: the kernel on the card, the plain
version on the CPU (mirrors ``merge/ops.py``), and the same top-k with
a gradient for the MoE router in training."""
from __future__ import annotations

import torch

from repro_torch.kernels.topk.ref import topk_ref
from repro_torch.kernels.topk.topk import topk_cuda


def local_topk(scores, k: int, *, index_offset: int = 0):
    """Top-k (f32 values, int32 global indices) of ``scores`` along the
    last axis.

    The paper's Local Query Execution: score local items, keep the k
    best couples.  ``index_offset`` turns local positions into global
    addresses.  A CPU tensor goes to the plain version (``topk_ref``), a
    CUDA tensor to the CUDA kernel (``topk_cuda``, which raises on what
    it does not take); there is no fallback between the two.
    """
    kind = scores.device.type
    if kind == "cpu":
        return topk_ref(scores, k, index_offset=index_offset)
    if kind == "cuda":
        return topk_cuda(scores, k, index_offset=index_offset)
    raise ValueError(f"local_topk: no path for {kind} tensors")


class TopkWithGrad(torch.autograd.Function):
    """:func:`local_topk` with ``lax.top_k``'s gradient.  The forward is
    ``local_topk`` unchanged (the kernel on the card, ``topk_ref`` on
    the CPU); the backward scatters the values' gradient back to the
    winners' positions, ``zeros_like(scores).scatter(-1, idx -
    index_offset, g_vals)`` in the scores' dtype, and zero elsewhere.
    The indices get no gradient."""

    @staticmethod
    def forward(ctx, scores, k, index_offset):
        vals, idx = local_topk(scores, k, index_offset=index_offset)
        ctx.save_for_backward(idx)
        ctx.scores_dtype, ctx.index_offset = scores.dtype, index_offset
        ctx.scores_shape = scores.shape
        ctx.mark_non_differentiable(idx)
        return vals, idx

    @staticmethod
    def backward(ctx, g_vals, _g_idx):
        (idx,) = ctx.saved_tensors
        g = g_vals.to(ctx.scores_dtype)
        zeros = torch.zeros(ctx.scores_shape, dtype=g.dtype,
                            device=g.device)
        return zeros.scatter(-1, idx.long() - ctx.index_offset, g), None, \
            None


def topk_with_grad(scores, k: int, *, index_offset: int = 0):
    """:func:`local_topk` that autograd differentiates as ``lax.top_k``:
    the MoE router's top-k (``models/moe.py``)."""
    return TopkWithGrad.apply(scores, k, index_offset)
