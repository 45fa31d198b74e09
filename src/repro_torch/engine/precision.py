"""Precision names and the torch dtypes they cast to.

The port's counterpart of ``repro.engine.precision.np_dtype``; the
tolerance contract of that module comes with the reduced-precision
slice of the port.
"""
from __future__ import annotations

import torch

_DTYPES = {"f64": torch.float64, "f32": torch.float32,
           "bf16": torch.bfloat16}


def torch_dtype(precision: str) -> torch.dtype:
    """The torch dtype a precision name casts scores to."""
    try:
        return _DTYPES[precision]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r}") from None
