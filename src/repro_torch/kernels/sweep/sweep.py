"""Wrappers of the CUDA forward-sweep kernels (``csrc/sweep.cu``).

``arrivals_cuda`` replaces
``src/repro/kernels/sweep/sweep.py::arrivals_pallas`` and
``wait_cuda`` replaces ``src/repro/kernels/sweep/sweep.py::wait_pallas``
(both variants).  Both kernels are bound by device-memory bytes: one
thread per output element, coalesced along the level axis.  Launch
counters: ``repro_torch.kernels._build.LAUNCHES["arrivals"]``,
``["wait"]`` and ``["wait_churn"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SUFFIX = {torch.float64: "f64", torch.float32: "f32",
           torch.bfloat16: "bf16"}
_IDX = {torch.int32: "i32", torch.int64: "i64"}
_P = ctypes.c_void_p
_LL = ctypes.c_longlong


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
    out = torch.empty_like(dn)
    if out.numel() == 0:
        return out
    fn = _build.function(
        "sweep", f"repro_arrivals_{_SUFFIX[dn.dtype]}_{_IDX[par_pos.dtype]}",
        [_P, _P, _P, _P, _LL, _LL, _LL, _P])
    code = fn(_build.ptr(tq_prev), _build.ptr(dn), _build.ptr(par_pos),
              _build.ptr(out), E, L, Lp, _build.stream(dev))
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
