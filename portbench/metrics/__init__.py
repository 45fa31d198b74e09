"""Arithmetic the per-layer readers share: a reader's file is
``<metric>.py`` with ``read(ctx) -> float | None``; ``ctx`` holds the
traced window (``trace``: ``yardstick/trace.py::Trace``), the driver's
``counts``, the ``cell``, ``busy_s`` and ``window_s``.  A reader that
finds nothing to read returns None and the metric is left out."""
from __future__ import annotations

from portbench.yardstick.trace import short

_COPIES = ("Memcpy", "Memset")


def kernels(ctx) -> list:
    """The traced window's kernels (copies and fills left out)."""
    return [op for op in ctx["trace"].ops
            if not op.name.startswith(_COPIES)]


def idle_pct(ctx):
    """The device's idle share of the window, in percent."""
    if not ctx["trace"].ops or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def per(ctx, key):
    """Kernels in the window per ``counts[key]``."""
    n = ctx["counts"].get(key)
    ks = kernels(ctx)
    return len(ks) / n if n and ks else None


def named_us(ctx, prefixes) -> float:
    """Summed device time (us) of kernels whose short name, past its
    last namespace, starts with one of ``prefixes``."""
    return sum(op.dur_us for op in kernels(ctx)
               if short(op.name).split("::")[-1].startswith(prefixes))
