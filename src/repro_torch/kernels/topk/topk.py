"""Wrapper of the CUDA local top-k kernels (``csrc/topk.cu``,
``csrc/topk_select.cu``).

Replaces ``src/repro/kernels/topk/topk.py::topk_pallas``.  Every route
is bound by device-memory bytes.  For ``k <= MAX_K`` the tile route
(``topk.cu``) reads each score once and finds the k largest of each
tile of ``TILE`` scores by a radix select on the scores' total-order
keys, then the k largest of a row's candidates.  A larger k takes one
of the two select routes of ``topk_select.cu``: ``resident`` when the
row, its k winners and the histogram's room fit one block's shared
memory (``resident_bytes(n, k) <= RESIDENT_SMEM``; one launch, each
score read once), else ``long`` (three launches, each score read twice:
a cluster a row picks the first digit's bin, a block per ``LTILE``
scores writes its candidates in row order, a block a row selects and
sorts them).  This module plans the route, the tiles and the scratch;
each launcher refuses any other plan.  Launch counters:
``repro_torch.kernels._build.LAUNCHES["topk"]`` (tile route) and
``["topk_select"]`` (both select routes).

:func:`topk_cuda` launches through the op ``repro_torch::topk``
(``torch.ops``), whose fake implementation gives the outputs' shapes
and dtypes and computes nothing, so that a fake-tensor trace or a
counter of ops (``roofline/trace.py``) sees each launch as one call.
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
#: the select routes' constants (``csrc/topk_select.cu``): the bytes of
#: a block's state and histogram room before its keys, a block's shared
#: memory (the resident route's limit), the scores of a long-route tile
#: block, the u32 of a long row's state and of a tile's line, and the
#: most winners the bitonic sort takes (a larger k takes the radix sort)
FIXED_BYTES = 16896
RESIDENT_SMEM = 232448
LTILE = 16384
STATE = 4
LINE = 4
SORT_SLOTS = 512
TILES, RESIDENT, LONG = "tiles", "resident", "long"
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


def _round4(n):
    return -(-n // 4) * 4


def resident_bytes(n: int, k: int) -> int:
    """Shared memory of the resident route for a row of ``n`` scores at
    ``k``: the state and the room, the row (once compacted, the sort's
    second buffer: keys and indices, ``max(k, SORT_SLOTS)`` each), the k
    winners."""
    return FIXED_BYTES + 4 * max(n + 4, 2 * max(k, SORT_SLOTS)) + 8 * k


def plan(n: int, k: int) -> TopkPlan:
    """The launch of a row of ``n`` scores at ``k``.

    ``k <= MAX_K``, the tile route: one pass-1 block per ``TILE``
    scores, and ``tiles * k`` words of scratch for pass 2 when a row has
    more than one tile (else 0).  A larger k: the resident route, no
    tiles and no scratch, when ``resident_bytes(n, k) <=
    RESIDENT_SMEM``; else the long route, ``ceil(n / LTILE)`` tiles and
    int64 scratch words a row (a multiple of 16 bytes) for its state
    (``STATE`` u32), the tiles' lines (``LINE`` u32 each: keys above the
    bin, bin keys kept, the bin's least and largest), their regions
    (keys and indices,
    ``min(LTILE, k)`` u32 each, rounded up to 4), the gathered
    candidates (as large) and the k winners (keys and indices).
    """
    if k <= MAX_K:
        tiles = _cdiv(n, TILE)
        return TopkPlan(TILES, tiles, tiles * k if tiles > 1 else 0)
    if resident_bytes(n, k) <= RESIDENT_SMEM:
        return TopkPlan(RESIDENT, 0, 0)
    tiles = _cdiv(n, LTILE)
    cap = _round4(min(LTILE, k))
    return TopkPlan(LONG, tiles, 2 * _cdiv(STATE + LINE * tiles
                                           + 4 * tiles * cap + 2 * k, 4))


def topk_cuda(scores, k: int, *, index_offset: int = 0):
    """Top-k (values, global indices) along the last axis, on the card.

    ``scores`` (..., n) is a contiguous CUDA tensor; f32, bf16 and f16
    are read as they are, any other dtype is cast to f32 first (as the
    reference's ``astype(float32)``).  Returns f32 values (..., k) in
    the reference's total order, descending, and int32 indices
    ``local + index_offset``; ties go to the lowest index.  Takes any
    ``1 <= k <= n`` (the tile route to ``MAX_K``, a select route
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
    return topk_op(scores, k, index_offset)


def _launch(scores, k: int, index_offset: int):
    dev = scores.device
    n = scores.shape[-1]
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


topk_op = torch.library.custom_op(
    "repro_torch::topk", _launch, mutates_args=(), device_types="cuda",
    schema="(Tensor scores, int k, int index_offset) -> (Tensor, Tensor)")


@topk_op.register_fake
def _(scores, k, index_offset):
    shape = tuple(scores.shape[:-1]) + (k,)
    return (scores.new_empty(shape, dtype=torch.float32),
            scores.new_empty(shape, dtype=torch.int32))
