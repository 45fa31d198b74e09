"""The reduced-precision tolerance contract, and the one host cast.

``SimEngine`` can run its forward sweep and merge folds in ``f32`` or
``bf16`` instead of the default ``f64``.  Reduced precision abandons
the bit-exactness contract (the f64 sweep == the reference package's
numpy batch == its scalar reference in every RNG mode) and replaces it
with a TOLERANCE contract, checked per query entry against the f64
ground truth:

  * **top-k set recall** — the fraction of the true top-k owner set
    recovered.  On well-separated scores (the generic case: scores are
    continuous draws, ties have measure zero in f64 but CAN collide
    after a bf16 cast) recall must be 1.0; rank swaps among
    near-degenerate scores only ever swap items whose scores agree to
    within the cast's epsilon, so the contract bounds the *score* gap
    instead of demanding set equality on ties.
  * **score rtol** — every reported top-k score matches the f64 score
    at the same rank within ``PRECISION_RTOL[precision]`` (relative,
    with an absolute epsilon guard for scores near zero).

The bounds come from the cast's machine epsilon amplified by the
merge-fold depth (scores pass through O(log n) pairwise merges, each a
comparison network — comparisons never create new values, so the only
error source is the initial cast plus the wait-time arithmetic):
``f32`` keeps ~7 significant digits (rtol 1e-4 is ~250 ulp of slack),
``bf16`` keeps ~2–3 (rtol 5e-2).

A copy of the reference package's ``engine.precision`` (the bounds,
``ToleranceReport`` and ``check_tolerance``), plus :func:`host_cast`,
the port's counterpart of the reference's host cast: every draw that a
reduced-precision sweep reads is narrowed here, once, on the host, by
torch's own conversion (f64 -> bf16 rounds through f32, bit for bit as
the reference's numpy cast does); a float64 tensor on a CUDA device is
never narrowed to bf16 there, since that cast may round once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

#: relative score tolerance per reduced precision (see module docstring)
PRECISION_RTOL = {"f64": 0.0, "f32": 1e-4, "bf16": 5e-2}
#: absolute epsilon guard for scores near zero
PRECISION_ATOL = {"f64": 0.0, "f32": 1e-6, "bf16": 1e-3}


_DTYPES = {"f64": torch.float64, "f32": torch.float32,
           "bf16": torch.bfloat16}


def torch_dtype(precision: str) -> torch.dtype:
    """The torch dtype a precision name casts scores to."""
    try:
        return _DTYPES[precision]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r}") from None


def host_cast(a, precision: str) -> torch.Tensor:
    """A host float64 array as a CPU tensor in ``precision``'s dtype.

    The only place a draw is narrowed: ``torch.from_numpy(a).to(dtype)``
    on the host, to be uploaded in that dtype.  ``"f64"`` returns the
    array's own memory, unconverted.
    """
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))
    return t.to(torch_dtype(precision))


@dataclasses.dataclass(frozen=True)
class ToleranceReport:
    """The measured contract of one reduced-precision run vs its f64
    ground truth.

    ``recall`` — mean over entries of |topk_lo ∩ topk_f64| / k on the
    owner sets; ``min_recall`` the worst entry.  ``max_rtol`` — the
    largest relative score deviation at matched ranks (0.0 when the
    lists agree bit-for-bit after the cast).  ``ok`` — the contract
    holds: ``max_rtol <= rtol_bound`` and, when scores are
    well-separated at the cast's resolution (``separated``), recall is
    exactly 1.0; on tied/near-degenerate scores only the rtol bound is
    enforced (the swap is between items the cast cannot distinguish).
    """

    precision: str
    recall: float
    min_recall: float
    max_rtol: float
    rtol_bound: float
    separated: bool
    ok: bool

    def summary(self) -> dict:
        """Flat dict for TopKResult.extras / bench rows."""
        return {"precision": self.precision, "recall": self.recall,
                "min_recall": self.min_recall, "max_rtol": self.max_rtol,
                "rtol_bound": self.rtol_bound,
                "separated": self.separated, "ok": self.ok}


def check_tolerance(precision: str, values_lo, owners_lo,
                    values_f64, owners_f64, *,
                    rtol: Optional[float] = None,
                    atol: Optional[float] = None) -> ToleranceReport:
    """Check a reduced-precision top-k result against the f64 truth.

    All four arrays are (E, k): per-entry top-k score lists (descending)
    and their owner ids.  Empty slots are -inf scores / owner -1 and
    must agree positionally (an empty slot is structural — it means the
    query reached fewer than k items — and no cast may change that).
    """
    rtol = PRECISION_RTOL[precision] if rtol is None else rtol
    atol = PRECISION_ATOL[precision] if atol is None else atol
    v_lo = np.asarray(values_lo, np.float64)
    v_hi = np.asarray(values_f64, np.float64)
    o_lo = np.asarray(owners_lo)
    o_hi = np.asarray(owners_f64)
    if v_lo.shape != v_hi.shape:
        raise ValueError(f"shape mismatch {v_lo.shape} vs {v_hi.shape}")
    E, k = v_hi.shape if v_hi.ndim == 2 else (1, v_hi.shape[-1])
    v_lo, v_hi = v_lo.reshape(E, k), v_hi.reshape(E, k)
    o_lo, o_hi = o_lo.reshape(E, k), o_hi.reshape(E, k)

    # owner-set recall per entry (empty slots excluded from the truth set)
    recalls = np.ones(E)
    for e in range(E):
        true = o_hi[e][o_hi[e] >= 0]
        if true.size:
            got = o_lo[e][o_lo[e] >= 0]
            recalls[e] = np.intersect1d(true, got).size / true.size

    # positional score rtol over non-empty slots; empty slots (-inf)
    # must agree exactly
    fin_hi, fin_lo = np.isfinite(v_hi), np.isfinite(v_lo)
    if not np.array_equal(fin_hi, fin_lo):
        # a slot filled on one side and empty on the other: structural
        # mismatch, report as an infinite deviation
        max_rtol = float("inf")
    elif fin_hi.any():
        denom = np.maximum(np.abs(v_hi[fin_hi]), atol / max(rtol, 1e-300)) \
            if rtol > 0 else np.maximum(np.abs(v_hi[fin_hi]), 1e-300)
        max_rtol = float(np.max(np.abs(v_lo[fin_hi] - v_hi[fin_hi])
                                / denom))
    else:
        max_rtol = 0.0

    # "well-separated at the cast's resolution": adjacent f64 ranks
    # differ by more than the rtol bound — then no cast-induced tie can
    # change the top-k SET and recall must be exactly 1.0
    if rtol > 0 and fin_hi.any() and k > 1:
        gaps = v_hi[:, :-1] - v_hi[:, 1:]
        both = fin_hi[:, :-1] & fin_hi[:, 1:]
        scale = np.maximum(np.abs(v_hi[:, :-1]), atol / rtol)
        separated = bool(np.all(gaps[both] > 2 * rtol * scale[both])) \
            if both.any() else True
    else:
        separated = True

    ok = max_rtol <= rtol and (not separated or bool(
        np.all(recalls == 1.0)))
    if precision == "f64":
        ok = max_rtol == 0.0 and bool(np.all(recalls == 1.0))
    return ToleranceReport(
        precision=precision, recall=float(recalls.mean()),
        min_recall=float(recalls.min()), max_rtol=max_rtol,
        rtol_bound=rtol, separated=separated, ok=ok)
