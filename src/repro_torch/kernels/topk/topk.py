"""Wrapper of the CUDA local top-k kernel (``csrc/topk.cu``).

Replaces ``src/repro/kernels/topk/topk.py::topk_pallas``.  The kernel
is bound by device-memory bytes; it reads each score once and finds the
k largest of each tile of ``TILE`` scores by a radix select on the
scores' total-order keys, then the k largest of a row's candidates (see
the note in the source).  This module plans the tiles and the scratch;
the launcher refuses any other plan.  Launch counter:
``repro_torch.kernels._build.LAUNCHES["topk"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: scores a pass-1 block holds (``TILE`` in ``csrc/topk.cu``)
TILE = 20480
MAX_K = 256
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_longlong, _P, _P, _P, _P]
_FNS: dict = {}                          # dtype -> launcher


def plan(n: int, k: int):
    """(tiles a row, candidate words a row) of a row of ``n`` scores:
    one pass-1 block per ``TILE`` scores, and ``tiles * k`` words of
    scratch for pass 2 when a row has more than one tile (else 0)."""
    tiles = -(-n // TILE)
    return tiles, (tiles * k if tiles > 1 else 0)


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
    lead = scores.shape[:-1]
    rows = scores.numel() // n
    vo = torch.empty(lead + (k,), dtype=torch.float32, device=dev)
    io = torch.empty(lead + (k,), dtype=torch.int32, device=dev)
    if rows == 0:
        return vo, io
    tiles, words = plan(n, k)
    cand = (torch.empty((rows, words), dtype=torch.int64, device=dev)
            if words else None)
    fn = _FNS.get(scores.dtype)
    if fn is None:
        fn = _FNS[scores.dtype] = _build.function(
            "topk", f"repro_topk_{_SUFFIX[scores.dtype]}", _ARGTYPES)
    code = fn(scores.data_ptr(), rows, n, k, index_offset, tiles,
              None if cand is None else cand.data_ptr(), vo.data_ptr(),
              io.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "topk")
    _build.LAUNCHES["topk"] += 1
    return vo, io
