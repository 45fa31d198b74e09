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
the launcher refuses any other plan.  The wait kernel moves 16 bytes of
every operand a thread on a level of at least ``WAIT_VEC_MIN_BYTES`` an
operand whose operands are all 16-byte aligned (in f64 the plain wait
only), else one element a thread, over blocks that cover the level;
:func:`wait_plan` computes that launch and the launcher refuses any
other.  Launch counters:
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
_WAIT_ARGTYPES = [_P] * 4 + [_LL] * 3 + [_P]
_WAIT_CHURN_ARGTYPES = [_P] * 6 + [_LL] * 3 + [_P]


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
#: the wait kernel's constants (``csrc/sweep.cu``)
WAIT_THREADS = 256           # threads of a wait block
WAIT_VEC_MIN_BYTES = 1 << 20  # an operand's bytes for the vector route
WAIT_SCALAR_LOAD_BYTES = 32  # a thread's scalar loads that keep scalar


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


class WaitPlan(NamedTuple):
    """The launch of one wait (the fields of ``csrc/sweep.cu``'s
    WaitPlan).

    The ``total`` elements are taken flat as ``total // vec`` vectors of
    ``vec`` elements (one 16-byte access; 1 on the scalar route).  Block
    b's thread t takes vector ``j = b * threads + t`` where ``j`` is
    below the vector count; block 0 also takes the tail, ``total %
    vec`` elements, one a thread.  Offsets are 64-bit.
    """
    vec: int
    threads: int
    grid: int


def wait_plan(total: int, itemsize: int, operands: int = 3, *,
              aligned: bool = True,
              vector: Optional[bool] = None) -> WaitPlan:
    """The wait launch of ``total`` elements of ``itemsize`` bytes and
    ``operands`` inputs (3, or 4 for the churn variant).

    ``aligned``: every operand and output starts on a 16-byte boundary.
    ``vector``: True takes the vector route (a 16-byte access moves
    ``16 // itemsize`` elements; needs ``aligned``), False the scalar
    route (one element), None chooses: the vector route where it can be
    taken, an operand holds at least ``WAIT_VEC_MIN_BYTES`` (a smaller
    launch is bound by its latency, and one element a thread is the
    shorter chain) and a thread's scalar loads, ``operands * itemsize``,
    are fewer than ``WAIT_SCALAR_LOAD_BYTES`` (the f64 churn variant's
    already keep the scalar route level with the vector one).  The grid
    covers the level, one vector a thread.  Raises ValueError where the
    request cannot be planned.
    """
    if total <= 0 or itemsize not in (2, 4, 8) or operands not in (3, 4):
        raise ValueError(f"wait_plan: {total} elements of {itemsize} "
                         f"bytes, {operands} operands")
    if vector is None:
        vector = (aligned and total * itemsize >= WAIT_VEC_MIN_BYTES
                  and operands * itemsize < WAIT_SCALAR_LOAD_BYTES)
    elif vector and not aligned:
        raise ValueError("wait_plan: the vector route needs 16-byte "
                         "aligned operands")
    vec = VEC_BYTES // itemsize if vector else 1
    grid = max(_cdiv(total // vec, WAIT_THREADS), 1)
    if grid >= 2 ** 31:
        raise ValueError(f"wait_plan: {total} elements exceed the grid")
    return WaitPlan(vec, WAIT_THREADS, grid)


def wait_cuda(own_ready, all_in, deadline, death=None):
    """Appendix-A send times on the card (optionally churned).

    All operands (E, L) contiguous CUDA tensors of one dtype.  Without
    ``death`` returns ``s``; with it returns ``(s, send)`` where ``send``
    is ``s`` masked to ``inf`` for a peer dead at its send time.
    """
    return _wait(own_ready, all_in, deadline, death)


def _wait(own_ready, all_in, deadline, death=None, vector=None, out=None):
    """:func:`wait_cuda` launched as ``wait_plan(..., vector=vector)``
    plans it, into ``out`` when given (``s``, or ``(s, send)`` with
    ``death``: contiguous tensors like the operands).  The on-card checks
    write into outputs filled with NaN, so that a skipped element shows,
    and force each route."""
    dev = own_ready.device
    if dev.type != "cuda":
        raise ValueError(f"wait_cuda needs CUDA tensors, got {dev}")
    if own_ready.dtype not in _SUFFIX:
        raise ValueError(f"wait: dtype must be one of {list(_SUFFIX)}, "
                         f"got {own_ready.dtype}")
    shape = tuple(own_ready.shape)
    ins = (own_ready, all_in, deadline) + (() if death is None
                                           else (death,))
    _check("wait", ins, shape, dev, own_ready.dtype)
    if out is None:
        outs = tuple(torch.empty_like(own_ready)
                     for _ in range(1 if death is None else 2))
    else:
        outs = (out,) if death is None else tuple(out)
    _check("wait", outs, shape, dev, own_ready.dtype)
    total = own_ready.numel()
    if total:
        plan = wait_plan(total, own_ready.element_size(), len(ins),
                         aligned=all(t.data_ptr() % VEC_BYTES == 0
                                     for t in ins + outs),
                         vector=vector)
        sfx = _SUFFIX[own_ready.dtype]
        name = "wait" if death is None else "wait_churn"
        fn = _build.function(
            "sweep", f"repro_{name}_{sfx}",
            _WAIT_ARGTYPES if death is None else _WAIT_CHURN_ARGTYPES)
        code = fn(*(_build.ptr(t) for t in ins + outs), total, plan.vec,
                  plan.grid, _build.stream(dev))
        _build.check(code, name)
        _build.LAUNCHES[name] += 1
    return outs[0] if death is None else outs
