"""Wrappers of the CUDA forward-sweep kernels (``csrc/sweep.cu``).

``arrivals_cuda`` replaces
``src/repro/kernels/sweep/sweep.py::arrivals_pallas`` and
``wait_cuda`` replaces ``src/repro/kernels/sweep/sweep.py::wait_pallas``
(both variants).  Both kernels are bound by device-memory bytes.  The
arrivals kernel runs on a 2-D grid (tiles of a row's columns times the
rows), so no thread divides to find its (e, l): one thread a column
that gathers its parent from L2, or, for a large level whose parent
row fits a block's shared memory, blocks that stage the row's parent
level there first and move dn and out 16 bytes a thread.
:func:`arrivals_plan` chooses between them and computes the launch;
the launcher refuses any other plan.  The wait kernel is one thread per
output element.  Launch counters:
``repro_torch.kernels._build.LAUNCHES["arrivals"]``, ``["wait"]`` and
``["wait_churn"]``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

_SUFFIX = {torch.float64: "f64", torch.float32: "f32",
           torch.bfloat16: "bf16"}
_IDX = {torch.int32: "i32", torch.int64: "i64"}
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARRIVALS_ARGTYPES = [_P, _P, _P, _P] + [_LL] * 6 + [_P]


#: the arrivals kernel's constants (``csrc/sweep.cu``)
ARR_THREADS = 512            # columns of a gathering block
STAGE_THREADS = 1024         # threads of a staging block
STAGE_ELEMS = 8              # loads in flight a staging thread
SMS = 132                    # the H100's SMs
SMEM_MAX = 232448            # a block's dynamic shared memory
VEC_BYTES = 16               # one vector access
SECTOR = 32                  # bytes a gather moves from L2
STAGE_MIN_BYTES = 1 << 21    # dn of a staged level
MAX_GRID_Y = 65535
WIDE_MARGIN = 1 << 17        # threads, slots and rows past the ends


class ArrivalsPlan(NamedTuple):
    """The launch of one level (the fields of ``csrc/sweep.cu``'s Plan).

    Block (x, y, z) serves row ``e = z * grid_y + y`` (rows past E
    return).  Gathering (``vec`` 1): columns ``[x*slots, (x+1)*slots)``,
    one a thread, each parent read from L2.  Staged: the block copies
    row e's parent level into ``smem`` bytes of shared memory and covers
    slots ``[x*slots, (x+1)*slots)``, ``threads`` apart; a slot is
    ``vec`` columns moved by one 16-byte access, cut at the 16-byte
    boundaries of the flat (E, L) array, so row e covers slot j as
    columns ``[vec*j - s, vec*j - s + vec)`` with ``s = (e * L) % vec``.
    ``wide``: 64-bit offsets.
    """
    vec: int
    staged: bool
    wide: bool
    threads: int
    grid_x: int
    grid_y: int
    grid_z: int
    slots: int
    smem: int


def _cdiv(a, b):
    return -(-a // b)


def row_slots(L: int, vec: int) -> int:
    """Slots a row of ``L`` columns may take: ``L / vec`` when every row
    starts aligned, else one more for the partial slots at the ends."""
    return L // vec if L % vec == 0 else (L + 2 * vec - 2) // vec


def arrivals_plan(E: int, L: int, Lp: int, itemsize: int, *,
                  aligned: bool = True,
                  staged: Optional[bool] = None) -> ArrivalsPlan:
    """The arrivals launch of an (E, L) level whose parent level is
    ``Lp`` wide, for elements of ``itemsize`` bytes.

    ``staged``: True copies each row's parent level into shared memory
    (one block per split of the row, ``SMS // E`` splits), False gathers
    it from L2, None chooses: stage a level whose ``dn`` holds at least
    ``STAGE_MIN_BYTES`` (a smaller launch is bound by its latency, and
    gathering is the shorter chain) where the parent row fits and its
    copies move fewer bytes than the gathers' sectors (``SECTOR`` bytes
    a column).  ``aligned``: ``dn`` and ``out`` start on 16-byte
    boundaries, so a staged slot is 16 bytes (else one column).
    Offsets are 64-bit where ``E * max(L, Lp) + WIDE_MARGIN`` reaches
    2**31.  Raises ValueError where the request cannot be planned.
    """
    if min(E, L, Lp, itemsize) <= 0:
        raise ValueError(f"arrivals_plan: empty shape E={E} L={L} Lp={Lp}")
    vec = VEC_BYTES // itemsize if aligned else 1
    slots_row = row_slots(L, vec)
    splits = min(1 if E >= SMS else SMS // E, slots_row)
    fits = Lp * itemsize <= SMEM_MAX
    if staged is None:
        staged = (fits and E * L * itemsize >= STAGE_MIN_BYTES
                  and splits * Lp * itemsize <= L * SECTOR)
    if staged and not fits:
        raise ValueError(f"arrivals_plan: a parent level of {Lp} x "
                         f"{itemsize} bytes cannot be staged")
    slots = _cdiv(slots_row, splits) if staged else ARR_THREADS
    grid_y = min(E, MAX_GRID_Y)
    plan = ArrivalsPlan(vec if staged else 1, bool(staged),
                        E * max(L, Lp) + WIDE_MARGIN >= 2 ** 31,
                        STAGE_THREADS if staged else ARR_THREADS,
                        _cdiv(slots_row if staged else L, slots), grid_y,
                        _cdiv(E, grid_y), slots,
                        Lp * itemsize if staged else 0)
    if plan.grid_z > MAX_GRID_Y or plan.grid_x >= 2 ** 31:
        raise ValueError(f"arrivals_plan: ({E}, {L}) exceeds the grid")
    return plan


def _check(name, ts, shape, device, dtype):
    for t in ts:
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{name}: operands must be contiguous {dtype} {shape} on "
                f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                + ("" if t.is_contiguous() else " (not contiguous)"))


def arrivals_cuda(tq_prev, dn, par_pos):
    """Level arrivals ``tq_prev[:, par_pos] + dn`` on the card.

    ``tq_prev`` (E, L_prev) and ``dn`` (E, L) contiguous CUDA tensors of
    one dtype (f64 / f32 / bf16), ``par_pos`` (L,) int32 or int64 with
    every value in ``[0, L_prev)`` (the plan's parent positions).
    Returns (E, L) in the input dtype.
    """
    return _arrivals(tq_prev, dn, par_pos, None)


def _arrivals(tq_prev, dn, par_pos, staged, out=None):
    """:func:`arrivals_cuda` launched as ``arrivals_plan(...,
    staged=staged)`` plans it, into ``out`` when given (an (E, L)
    contiguous tensor like ``dn``).  The on-card checks force either way
    here, into an output filled with NaN so that a skipped element
    shows."""
    dev = tq_prev.device
    if dev.type != "cuda":
        raise ValueError(f"arrivals_cuda needs CUDA tensors, got {dev}")
    if tq_prev.dtype not in _SUFFIX:
        raise ValueError(f"arrivals: dtype must be one of {list(_SUFFIX)}, "
                         f"got {tq_prev.dtype}")
    if dn.dim() != 2 or tq_prev.dim() != 2:
        raise ValueError("arrivals: tq_prev and dn must be 2-D")
    E, Lp = tq_prev.shape
    L = dn.shape[1]
    _check("arrivals", (tq_prev,), (E, Lp), dev, tq_prev.dtype)
    _check("arrivals", (dn,), (E, L), dev, tq_prev.dtype)
    if par_pos.dtype not in _IDX:
        raise ValueError(f"arrivals: par_pos must be int32 or int64, got "
                         f"{par_pos.dtype}")
    _check("arrivals", (par_pos,), (L,), dev, par_pos.dtype)
    if out is None:
        out = torch.empty_like(dn)
    _check("arrivals", (out,), (E, L), dev, tq_prev.dtype)
    if out.numel() == 0:
        return out
    plan = arrivals_plan(
        E, L, Lp, dn.element_size(),
        aligned=dn.data_ptr() % VEC_BYTES == 0
        and out.data_ptr() % VEC_BYTES == 0, staged=staged)
    fn = _build.function(
        "sweep", f"repro_arrivals_{_SUFFIX[dn.dtype]}_{_IDX[par_pos.dtype]}",
        _ARRIVALS_ARGTYPES)
    code = fn(_build.ptr(tq_prev), _build.ptr(dn), _build.ptr(par_pos),
              _build.ptr(out), E, L, Lp, plan.vec, int(plan.staged),
              int(plan.wide), _build.stream(dev))
    _build.check(code, "arrivals")
    _build.LAUNCHES["arrivals"] += 1
    return out


def wait_cuda(own_ready, all_in, deadline, death=None):
    """Appendix-A send times on the card (optionally churned).

    All operands (E, L) contiguous CUDA tensors of one dtype.  Without
    ``death`` returns ``s``; with it returns ``(s, send)`` where ``send``
    is ``s`` masked to ``inf`` for a peer dead at its send time.
    """
    dev = own_ready.device
    if dev.type != "cuda":
        raise ValueError(f"wait_cuda needs CUDA tensors, got {dev}")
    if own_ready.dtype not in _SUFFIX:
        raise ValueError(f"wait: dtype must be one of {list(_SUFFIX)}, "
                         f"got {own_ready.dtype}")
    shape = tuple(own_ready.shape)
    ops = (own_ready, all_in, deadline) + (() if death is None
                                           else (death,))
    _check("wait", ops, shape, dev, own_ready.dtype)
    sfx = _SUFFIX[own_ready.dtype]
    s = torch.empty_like(own_ready)
    total = s.numel()
    if death is None:
        if total:
            fn = _build.function("sweep", f"repro_wait_{sfx}",
                                 [_P, _P, _P, _P, _LL, _P])
            code = fn(_build.ptr(own_ready), _build.ptr(all_in),
                      _build.ptr(deadline), _build.ptr(s), total,
                      _build.stream(dev))
            _build.check(code, "wait")
            _build.LAUNCHES["wait"] += 1
        return s
    send = torch.empty_like(own_ready)
    if total:
        fn = _build.function("sweep", f"repro_wait_churn_{sfx}",
                             [_P, _P, _P, _P, _P, _P, _LL, _P])
        code = fn(_build.ptr(own_ready), _build.ptr(all_in),
                  _build.ptr(deadline), _build.ptr(death), _build.ptr(s),
                  _build.ptr(send), total, _build.stream(dev))
        _build.check(code, "wait_churn")
        _build.LAUNCHES["wait_churn"] += 1
    return s, send
