"""Wrapper of the CUDA score-list merge kernel (``csrc/merge.cu``).

Replaces ``src/repro/kernels/merge/merge.py::merge_pallas``.  The kernel
is bound by device-memory bytes; it merges by rank (see the note in the
source).  Launch counter: ``repro_torch.kernels._build.LAUNCHES["merge"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SUFFIX = {torch.float64: "f64", torch.float32: "f32",
           torch.bfloat16: "bf16"}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]
MAX_K = 512


def _mask(valid, lead, device):
    if valid is None:
        return None
    if (valid.dtype != torch.bool or tuple(valid.shape) != lead
            or valid.device != device or not valid.is_contiguous()):
        raise ValueError(
            f"merge: a validity mask must be a contiguous bool tensor of "
            f"shape {lead} on {device}, got {valid.dtype} "
            f"{tuple(valid.shape)} on {valid.device}")
    return valid.view(torch.uint8)


def merge_cuda(vals_a, idx_a, vals_b, idx_b, valid_a=None, valid_b=None):
    """Top-k of the union of two descending k-lists, on the card.

    PRECONDITION: every row of ``vals_a`` and of ``vals_b`` is sorted
    descending (non-increasing; ``-inf`` tails allowed).  The kernel
    computes each element's output position from that order, so an
    unsorted row gives a wrong (not merely unsorted) result.  Every list
    the sweep merges is sorted: own lists come sorted from the
    order-statistics draw, and merges preserve the order.

    ``vals_*`` (..., k) in f64 / f32 / bf16 (both the same), ``idx_*``
    (..., k) int32, all contiguous CUDA tensors of one shape; ``valid_*``
    optional (...) bool row masks (an invalid list is all ``-inf``).
    Returns ``(values, owners)``; ties go to list ``a``, then to the
    lower position — the plain version's rule.
    """
    shape = tuple(vals_a.shape)
    lead, k = shape[:-1], shape[-1]
    dev = vals_a.device
    if dev.type != "cuda":
        raise ValueError(f"merge_cuda needs CUDA tensors, got {dev}")
    if vals_a.dtype not in _SUFFIX or vals_b.dtype != vals_a.dtype:
        raise ValueError(f"merge: values must share one of "
                         f"{list(_SUFFIX)}, got {vals_a.dtype} and "
                         f"{vals_b.dtype}")
    if idx_a.dtype != torch.int32 or idx_b.dtype != torch.int32:
        raise ValueError(f"merge: owners must be int32, got {idx_a.dtype} "
                         f"and {idx_b.dtype}")
    for t in (vals_b, idx_a, idx_b):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"merge: every list must be {shape} on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
    for t in (vals_a, vals_b, idx_a, idx_b):
        if not t.is_contiguous():
            raise ValueError("merge: lists must be contiguous")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"merge: list length must be in [1, {MAX_K}], "
                         f"got {k}")
    ma = _mask(valid_a, lead, dev)
    mb = _mask(valid_b, lead, dev)
    vo = torch.empty_like(vals_a)
    io = torch.empty_like(idx_a)
    rows = vals_a.numel() // k
    if rows == 0:
        return vo, io
    fn = _build.function("merge", f"repro_merge_{_SUFFIX[vals_a.dtype]}",
                         _ARGTYPES)
    code = fn(_build.ptr(vals_a), _build.ptr(idx_a), _build.ptr(vals_b),
              _build.ptr(idx_b), _build.ptr(ma), _build.ptr(mb),
              _build.ptr(vo), _build.ptr(io), rows, k, _build.stream(dev))
    _build.check(code, "merge")
    _build.LAUNCHES["merge"] += 1
    return vo, io
