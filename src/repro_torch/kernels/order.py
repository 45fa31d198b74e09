"""The order in which the reference's ``jax.lax.top_k`` ranks floats.

``lax.top_k`` ranks by the IEEE total order of the value's bits:

    +NaN > +inf > ... > +0.0 > -0.0 > ... > -inf > -NaN

(NaNs by payload too).  A float comparison calls +0.0 and -0.0 equal
and NaN unordered, so the port's plain versions sort on an integer key
of the bits instead, and the CUDA kernels compare the same key.  They
also gather the winners as bits: torch's vectorized CPU gather of bf16
turns a NaN into another NaN.
"""
from __future__ import annotations

import torch


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """Signed integer keys whose order is the IEEE total order of ``x``.

    f64 gives int64 keys; f32 int32; bf16 and f16 their 16 bits widened
    to int32.  Flipping the magnitude bits of a negative value turns
    sign-magnitude into two's-complement order.
    """
    if x.dtype == torch.float64:
        b = x.view(torch.int64)
        return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFF)
    if x.dtype == torch.float32:
        b = x.view(torch.int32)
    elif x.dtype in (torch.bfloat16, torch.float16):
        b = x.view(torch.int16).to(torch.int32)
    else:
        raise ValueError(f"total_order_key: no key for {x.dtype}")
    return b ^ ((b >> 31) & 0x7FFFFFFF)


_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def take_bits(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``take_along_dim(x, pos, dim=-1)`` moving the bits unchanged."""
    if not x.dtype.is_floating_point:
        return torch.take_along_dim(x, pos, dim=-1)
    bits = _BITS[x.element_size()]
    return torch.take_along_dim(x.view(bits), pos, dim=-1).view(x.dtype)
