"""Wrapper of the CUDA score-list merge kernel (``csrc/merge.cu``).

Replaces ``src/repro/kernels/merge/merge.py::merge_pallas``.  The kernel
is bound by device-memory bytes; it merges by rank (see the note in the
source) on one of three routes that :func:`merge_plan` chooses:

* ``BULK``: the sweep's k = 32 (``BULK_K``) only; persistent blocks walk
  tiles of ``rows_per_tile`` row pairs, each copied into a ring of
  shared-memory stages by TMA bulk copies and written back by one bulk
  store;
* ``DIRECT``: one block a tile read and written in place (for
  16 < k <= 32 from ``WARP_MIN_ROWS`` rows a warp a row pair; else the
  first design, one thread an element), for every other
  k <= ``MAX_TILE_K``, a base off 16 bytes, or a launch too small for
  the ring;
* ``ROW``: one block a row pair, for lists longer than ``MAX_TILE_K``.

The launcher recomputes the plan and refuses any other.  Launch counter:
``repro_torch.kernels._build.LAUNCHES["merge"]``.

A merge into new outputs launches through the op ``repro_torch::merge``
(``torch.ops``), whose fake implementation gives the outputs' shapes
and dtypes and computes nothing, so that a fake-tensor trace or a
counter of ops (``roofline/trace.py``) sees each launch as one call; a
merge into given outputs (``out=``) launches directly.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.order import take_bits, total_order_key

_SUFFIX = {torch.float64: "f64", torch.float32: "f32",
           torch.bfloat16: "bf16"}
_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = [_P] * 8 + [_LL, ctypes.c_int, _LL, _LL, _LL, _P]

#: the merge kernel's constants (``csrc/merge.cu``)
THREADS = 256            # a block's threads, every route
MAX_TILE_K = 512         # longest list a block holds
BULK_K = 32              # the one list length of the ring
STAGE_BYTES = 12288      # a bulk stage: the four lists of a tile
STAGES = 3               # tiles a bulk block has in flight
SMS = 132                # the H100's SMs
SM_SMEM = 233472         # an SM's shared memory
SMEM_RESERVED = 1024     # shared memory the card keeps a block
SMEM_MAX = 232448        # a block's dynamic shared memory
BULK_BLOCKS = 4          # bulk blocks an SM holds at most
ROW_BLOCKS = 8           # row-route blocks an SM holds
SM_THREADS = 2048        # threads an SM holds
# the ring pays where a direct launch keeps fewer bytes in flight an SM
# than DIRECT_INFLIGHT and the launch has BULK_MIN_ROWS rows (H100)
DIRECT_INFLIGHT = 40960
BULK_MIN_ROWS = 96000
# a direct launch of 16 < k <= 32 a warp a row pair from WARP_MIN_ROWS
# rows (below them the first design's launch is faster on the H100)
WARP_MIN_ROWS = 2048
ALIGN = 16               # a bulk copy's address and size

BULK, DIRECT, ROW = 0, 1, 2
ROUTES = ("bulk", "direct", "row")


class MergePlan(NamedTuple):
    """The launch of one merge (the fields of ``csrc/merge.cu``'s Plan).

    Block b serves tiles ``b, b + grid, ...`` of ``rows_per_tile`` row
    pairs (the row route: one row pair a tile; the direct route: one
    tile a block) with ``threads`` threads, each ranking ``ept`` elements
    of a tile; a bulk block keeps ``stages`` tiles in flight in ``smem``
    bytes of shared memory.
    """
    route: int
    rows_per_tile: int
    ept: int
    stages: int
    threads: int
    tiles: int
    grid: int
    smem: int


def _cdiv(a, b):
    return -(-a // b)


def bulk_rows(itemsize: int) -> int:
    """Rows of a bulk tile: a stage of ``STAGE_BYTES`` (16, 24 and 32
    rows in f64, f32 and bf16)."""
    return STAGE_BYTES // (itemsize + 4) // (2 * BULK_K)


def bulk_smem(itemsize: int) -> int:
    """Shared memory of a bulk block: the ring (va, ia, vb, ib a stage),
    the output tile, the masks, an mbarrier a stage."""
    R = bulk_rows(itemsize)
    n = R * BULK_K
    return (STAGES * 2 * n * (itemsize + 4) + n * (itemsize + 4)
            + _cdiv(2 * R, ALIGN) * ALIGN + 8 * STAGES)


def warp_rows(rows: int, k: int) -> bool:
    """The direct route takes a row pair a warp: 16 < k <= 32, from
    ``WARP_MIN_ROWS`` rows."""
    return 16 < k <= 32 and rows >= WARP_MIN_ROWS


def merge_plan(rows: int, k: int, dtype, ptrs: Sequence[int] = (), *,
               route: Optional[int] = None) -> MergePlan:
    """The launch of a merge of ``rows`` row pairs of k-lists of
    ``dtype`` values (a torch dtype, or its size in bytes).

    ``ptrs``: the data pointers of the six lists (values and owners of
    a, b and the output); the bulk route needs all of them 16-byte
    aligned.  ``route``: ``BULK``, ``DIRECT`` or ``ROW`` forces it, None
    chooses: ``ROW`` where ``k > MAX_TILE_K``, ``BULK`` where k is
    ``BULK_K``, the bases align, the launch has ``BULK_MIN_ROWS`` rows
    and a direct launch would keep fewer than ``DIRECT_INFLIGHT`` bytes
    in flight an SM (f32 and bf16), else ``DIRECT``.  Raises ValueError
    where the request cannot be planned.
    """
    itemsize = (dtype if isinstance(dtype, int)
                else torch.empty((), dtype=dtype).element_size())
    if rows <= 0 or k <= 0 or itemsize not in (2, 4, 8):
        raise ValueError(f"merge_plan: cannot plan rows={rows} k={k} "
                         f"itemsize={itemsize}")
    aligned = all(p % ALIGN == 0 for p in ptrs)
    fits = k <= MAX_TILE_K
    bulk_ok = aligned and k == BULK_K
    # bytes a direct launch of k = 32 keeps in flight an SM: a row pair a
    # warp
    inflight = SM_THREADS // 32 * 2 * BULK_K * (itemsize + 4)
    if route is None:
        route = (ROW if not fits else BULK
                 if bulk_ok and rows >= BULK_MIN_ROWS
                 and inflight < DIRECT_INFLIGHT else DIRECT)
    if (route == BULK and not bulk_ok) or (route == DIRECT and not fits) \
            or route not in (BULK, DIRECT, ROW):
        raise ValueError(f"merge_plan: route {route} cannot take rows={rows}"
                         f" k={k} itemsize={itemsize} aligned={aligned}")
    threads = THREADS
    if route == BULK:
        R, stages, smem = bulk_rows(itemsize), STAGES, bulk_smem(itemsize)
        ept = 2 * BULK_K * R // THREADS
        blocks = min(BULK_BLOCKS, SM_SMEM // (smem + SMEM_RESERVED))
    elif route == DIRECT:
        stages, blocks = 0, None        # one block a tile
        if warp_rows(rows, k):
            # a warp a row pair, two elements a lane
            R, ept, smem = THREADS // 32, 2, 0
        else:
            # one thread an element: as many rows a block as THREADS
            # threads hold, or one row of 2k threads where that is more
            R, ept = 1 if 2 * k >= THREADS else THREADS // (2 * k), 1
            threads = 2 * k * R
            smem = threads * (8 if itemsize == 8 else 4)
    else:
        R, ept, stages, smem, blocks = 1, 0, 0, 0, ROW_BLOCKS
    tiles = _cdiv(rows, R)
    grid = tiles if blocks is None else min(tiles, SMS * blocks)
    if grid >= 2 ** 31:
        raise ValueError(f"merge_plan: {rows} rows exceed the grid")
    return MergePlan(route, R, ept, stages, threads, tiles, grid, smem)


def compute_dtype(vals_a, vals_b):
    """The dtype a merge computes in, as ``merge_ref`` and
    ``merge_pallas`` choose it for each list: its own type, with f16 and
    non-float types promoted to f32.  Two lists that do not come to one
    type (f32 with f64, bf16 with f32, ...) are refused (ValueError):
    only the promotion to f32 keeps the total order on the card, by the
    sort again in :func:`_promote`."""
    def one(dt):
        return (dt if dt.is_floating_point and dt != torch.float16
                else torch.float32)
    da, db = one(vals_a.dtype), one(vals_b.dtype)
    if da != db:
        raise ValueError(f"merge: cannot merge {vals_a.dtype} and "
                         f"{vals_b.dtype} lists")
    return da


def _promote(vals, idx, valid, dt):
    """A list cast to the compute dtype ``dt`` as ``merge_ref`` casts it,
    with its owners and row mask.  The card's f16 -> f32 cast turns every
    NaN into the one +NaN, so an f16 list holding a NaN can leave the
    total order the kernel needs: such a list is masked first (as
    ``merge_ref`` masks before it casts), then sorted again, stably,
    which keeps equal keys in the order ``merge_ref``'s stable sort gives
    them."""
    if vals.dtype == dt:
        return vals, idx, valid
    if vals.dtype == torch.float16:
        if valid is not None:
            _mask(valid, tuple(vals.shape[:-1]), vals.device)
            vals = torch.where(valid[..., None], vals, float("-inf"))
            valid = None
        v = vals.to(dt)
        order = torch.sort(total_order_key(v), dim=-1, descending=True,
                           stable=True).indices
        return (take_bits(v, order).contiguous(),
                torch.gather(idx, -1, order).contiguous(), None)
    return vals.to(dt).contiguous(), idx, valid


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


def merge_cuda(vals_a, idx_a, vals_b, idx_b, valid_a=None, valid_b=None,
               out=None):
    """Top-k of the union of two descending k-lists, on the card.

    PRECONDITION: every row of ``vals_a`` and of ``vals_b`` is sorted
    descending (non-increasing; ``-inf`` tails allowed).  The kernel
    computes each element's output position from that order, so an
    unsorted row gives a wrong (not merely unsorted) result.  Every list
    the sweep merges is sorted: own lists come sorted from the
    order-statistics draw, and merges preserve the order.

    ``vals_*`` (..., k), any k >= 1, ``idx_*`` (..., k) int32, all
    contiguous CUDA tensors of one shape; the values merge in
    :func:`compute_dtype` (f64, f32 and bf16 in their own type, f16 and
    integers in f32, as the plain version does).  ``valid_*`` optional
    (...) bool row masks (an invalid list is all ``-inf``).  ``out``: a
    pair ``(values, owners)`` of contiguous tensors to write into.
    Returns ``(values, owners)``; ties go to list ``a``, then to the
    lower position — the plain version's rule.
    """
    if out is None:
        _check(vals_a, idx_a, vals_b, idx_b)
        return merge_op(vals_a, idx_a, vals_b, idx_b, valid_a, valid_b)
    return _merge(vals_a, idx_a, vals_b, idx_b, valid_a, valid_b, None, out)


def _check(vals_a, idx_a, vals_b, idx_b):
    """Refuse lists the kernel does not take (ValueError); returns
    their shape and compute dtype."""
    shape = tuple(vals_a.shape)
    dev = vals_a.device
    if dev.type != "cuda":
        raise ValueError(f"merge_cuda needs CUDA tensors, got {dev}")
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
    if shape[-1] < 1:
        raise ValueError(f"merge: list length must be >= 1, got "
                         f"{shape[-1]}")
    dt = compute_dtype(vals_a, vals_b)
    if dt not in _SUFFIX:
        raise ValueError(f"merge: cannot merge {vals_a.dtype} and "
                         f"{vals_b.dtype} lists")
    return shape, dt


def _merge(vals_a, idx_a, vals_b, idx_b, valid_a=None, valid_b=None,
           route=None, out=None):
    """:func:`merge_cuda` launched on the route ``merge_plan(...,
    route=route)`` plans.  The on-card checks force each route here, into
    outputs filled with NaN so that a skipped element shows."""
    shape, dt = _check(vals_a, idx_a, vals_b, idx_b)
    lead, k = shape[:-1], shape[-1]
    dev = vals_a.device
    vals_a, idx_a, valid_a = _promote(vals_a, idx_a, valid_a, dt)
    vals_b, idx_b, valid_b = _promote(vals_b, idx_b, valid_b, dt)
    ma = _mask(valid_a, lead, dev)
    mb = _mask(valid_b, lead, dev)
    if out is None:
        vo = torch.empty(shape, dtype=dt, device=dev)
        io = torch.empty(shape, dtype=torch.int32, device=dev)
    else:
        vo, io = out
        for t, want in ((vo, dt), (io, torch.int32)):
            if (tuple(t.shape) != shape or t.dtype != want
                    or t.device != dev or not t.is_contiguous()):
                raise ValueError(
                    f"merge: out must be contiguous {want} {shape} on "
                    f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    rows = vals_a.numel() // k
    if rows == 0:
        return vo, io
    plan = merge_plan(rows, k, dt, [t.data_ptr() for t in
                                    (vals_a, idx_a, vals_b, idx_b, vo, io)],
                      route=route)
    fn = _build.function("merge", f"repro_merge_{_SUFFIX[dt]}", _ARGTYPES)
    code = fn(_build.ptr(vals_a), _build.ptr(idx_a), _build.ptr(vals_b),
              _build.ptr(idx_b), _build.ptr(ma), _build.ptr(mb),
              _build.ptr(vo), _build.ptr(io), rows, k, plan.route,
              plan.rows_per_tile, plan.grid, _build.stream(dev))
    _build.check(code, "merge")
    _build.LAUNCHES["merge"] += 1
    return vo, io


merge_op = torch.library.custom_op(
    "repro_torch::merge", _merge, mutates_args=(), device_types="cuda",
    schema="(Tensor vals_a, Tensor idx_a, Tensor vals_b, Tensor idx_b, "
           "Tensor? valid_a, Tensor? valid_b) -> (Tensor, Tensor)")


@merge_op.register_fake
def _(vals_a, idx_a, vals_b, idx_b, valid_a, valid_b):
    dt = compute_dtype(vals_a, vals_b)
    for valid in (valid_a, valid_b):
        _mask(valid, tuple(vals_a.shape[:-1]), vals_a.device)
    return (vals_a.new_empty(vals_a.shape, dtype=dt),
            vals_a.new_empty(vals_a.shape, dtype=torch.int32))
