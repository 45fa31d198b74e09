"""Wrapper of the CUDA local top-k kernels (``csrc/topk.cu``,
``csrc/topk_select.cu``).

Replaces ``src/repro/kernels/topk/topk.py::topk_pallas``.  Both routes
are bound by device-memory bytes.  For ``k <= MAX_K`` the tile route
(``topk.cu``) reads each score once and finds the k largest of each
tile of ``TILE`` scores by a radix select on the scores' total-order
keys, then the k largest of a row's candidates.  For a larger k the
select route (``topk_select.cu``) finds each row's k-th largest key by
a radix select over the row in device memory, writes the winners to
scratch and sorts them there (see the notes in the sources).  This
module plans the route, the tiles and the scratch; each launcher
refuses any other plan.  Launch counters:
``repro_torch.kernels._build.LAUNCHES["topk"]`` (tile route) and
``["topk_select"]``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

#: scores a pass-1 block of the tile route holds (``TILE`` in
#: ``csrc/topk.cu``), and the largest k that route takes
TILE = 20480
MAX_K = 256
#: the select route's constants (``csrc/topk_select.cu``): scores a
#: row-pass block takes, the first digit's bins, u32 of a row's state
SEL_TILE = 16384
SEL_FIRST_BINS = 4096
SEL_STATE = 4
TILES, SELECT = "tiles", "select"
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_longlong, _P, _P, _P, _P]
_FNS: dict = {}                          # (route, dtype) -> launcher


class TopkPlan(NamedTuple):
    """The launch of rows of ``n`` scores at k: the route, its tiles a
    row and the int64 scratch words a row."""
    route: str
    tiles: int
    words: int


def _cdiv(a, b):
    return -(-a // b)


def plan(n: int, k: int) -> TopkPlan:
    """The launch of a row of ``n`` scores at ``k``.

    ``k <= MAX_K``, the tile route: one pass-1 block per ``TILE``
    scores, and ``tiles * k`` words of scratch for pass 2 when a row has
    more than one tile (else 0).  A larger k, the select route: tiles of
    ``SEL_TILE`` scores, and a row's scratch of two k-word buffers, the
    histogram (``SEL_FIRST_BINS`` u32), the row's state (``SEL_STATE``
    u32) and the tiles' counts (u32 each).
    """
    if k <= MAX_K:
        tiles = _cdiv(n, TILE)
        return TopkPlan(TILES, tiles, tiles * k if tiles > 1 else 0)
    tiles = _cdiv(n, SEL_TILE)
    return TopkPlan(SELECT, tiles, 2 * k + SEL_FIRST_BINS // 2
                    + SEL_STATE // 2 + _cdiv(tiles, 2))


def topk_cuda(scores, k: int, *, index_offset: int = 0):
    """Top-k (values, global indices) along the last axis, on the card.

    ``scores`` (..., n) is a contiguous CUDA tensor; f32, bf16 and f16
    are read as they are, any other dtype is cast to f32 first (as the
    reference's ``astype(float32)``).  Returns f32 values (..., k) in
    the reference's total order, descending, and int32 indices
    ``local + index_offset``; ties go to the lowest index.  Takes any
    ``1 <= k <= n`` (the tile route to ``MAX_K``, the select route
    above), ``0 <= index_offset`` and ``n + index_offset <= 2**31``.
    """
    dev = scores.device
    if dev.type != "cuda":
        raise ValueError(f"topk_cuda needs a CUDA tensor, got {dev}")
    if scores.dim() < 1 or not scores.is_contiguous():
        raise ValueError("topk: scores must be a contiguous tensor of "
                         "at least one dimension")
    n = scores.shape[-1]
    if not 1 <= k <= n:
        raise ValueError(f"topk: k must be in [1, n={n}], got {k}")
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
    p = plan(n, k)
    scratch = (torch.empty((rows, p.words), dtype=torch.int64, device=dev)
               if p.words else None)
    fn = _FNS.get((p.route, scores.dtype))
    if fn is None:
        lib, name = (("topk", "repro_topk") if p.route == TILES
                     else ("topk_select", "repro_topk_select"))
        fn = _FNS[(p.route, scores.dtype)] = _build.function(
            lib, f"{name}_{_SUFFIX[scores.dtype]}", _ARGTYPES)
    code = fn(scores.data_ptr(), rows, n, k, index_offset, p.tiles,
              None if scratch is None else scratch.data_ptr(),
              vo.data_ptr(), io.data_ptr(),
              torch.cuda.current_stream(dev).cuda_stream)
    counter = "topk" if p.route == TILES else "topk_select"
    _build.check(code, counter)
    _build.LAUNCHES[counter] += 1
    return vo, io
