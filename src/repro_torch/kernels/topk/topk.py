"""Wrapper of the CUDA local top-k kernel (``csrc/topk.cu``).

Replaces ``src/repro/kernels/topk/topk.py::topk_pallas``.  The kernel
is bound by device-memory bytes; it reduces tiles of each row to k
candidates with a block argmax, then the candidates of a row (see the
note in the source).  Launch counter:
``repro_torch.kernels._build.LAUNCHES["topk"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, _P, _P, _P, _P]
MAX_K = 256


def topk_cuda(scores, k: int, *, index_offset: int = 0):
    """Top-k (values, global indices) along the last axis, on the card.

    ``scores`` (..., n) is a contiguous CUDA tensor; f32, bf16 and f16
    are read as they are, any other dtype is cast to f32 first (as the
    reference's ``astype(float32)``).  Returns f32 values (..., k) in
    the reference's total order, descending, and int32 indices
    ``local + index_offset``; ties go to the lowest index.  Needs
    ``1 <= k <= min(n, MAX_K)`` and ``0 <= index_offset``,
    ``n + index_offset <= 2**31``.
    """
    dev = scores.device
    if dev.type != "cuda":
        raise ValueError(f"topk_cuda needs a CUDA tensor, got {dev}")
    if scores.dim() < 1 or not scores.is_contiguous():
        raise ValueError("topk: scores must be a contiguous tensor of "
                         "at least one dimension")
    n = scores.shape[-1]
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"topk: k must be in [1, min(n={n}, {MAX_K})], "
                         f"got {k}")
    if index_offset < 0 or n + index_offset > 2 ** 31:
        raise ValueError(f"topk: global indices of n={n} from offset "
                         f"{index_offset} do not fit int32")
    if scores.dtype not in _SUFFIX:
        scores = scores.to(torch.float32)
    lead = tuple(scores.shape[:-1])
    rows = scores.numel() // n
    vo = torch.empty(lead + (k,), dtype=torch.float32, device=dev)
    io = torch.empty(lead + (k,), dtype=torch.int32, device=dev)
    if rows == 0:
        return vo, io
    words = _build.function("topk", "repro_topk_scratch",
                            [ctypes.c_longlong, ctypes.c_int],
                            restype=ctypes.c_longlong)(n, k)
    cand = (torch.empty((rows, words), dtype=torch.int64, device=dev)
            if words else None)
    fn = _build.function("topk", f"repro_topk_{_SUFFIX[scores.dtype]}",
                         _ARGTYPES)
    code = fn(_build.ptr(scores), rows, n, k, index_offset, _build.ptr(cand),
              _build.ptr(vo), _build.ptr(io), _build.stream(dev))
    _build.check(code, "topk")
    _build.LAUNCHES["topk"] += 1
    return vo, io
