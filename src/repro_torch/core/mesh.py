"""A mesh of virtual peers on one torch device, and its collectives.

The reference runs FD as ``shard_map`` collectives over a JAX device
mesh: each device is a peer and holds one shard of the score axis.  The
port keeps the peers on ONE device as a tensor axis: a shard of mesh
axis ``"model"`` of size P is the view ``(..., P, n_local)`` of a
``(..., N)`` score tensor, and row p of the peer axis is what device p
holds under ``shard_map``.  The collectives become tensor operations on
that axis (``ppermute``, ``psum``, ``all_gather``, ``axis_index``), and
a replicated output is peer 0's row, which is what ``shard_map``
returns for an output that is replicated over the axis.

Why not ``torch.distributed``: NCCL refuses two ranks on one card, so a
one-card run would have an axis of size 1 and no merge round at all.

A ``"data"`` mesh axis would shard only the batch of queries; every
collective is elementwise per batch row, so on one device it changes no
bit and the port keeps the batch whole.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch


def resolve_device(device=None, what: str = "this engine") -> torch.device:
    """The device to run on: ``"cuda"`` unless the caller names another.

    With ``device=None`` and no CUDA device this raises — the port never
    carries on on the CPU unasked.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path")
        device = "cuda"
    return torch.device(device)


class Mesh:
    """Named mesh axes over virtual peers held on one ``device``.

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``
    does.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match "
                             f"axis names {tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {tuple(axis_names)}")
        if any(int(s) < 1 for s in shape):
            raise ValueError(f"mesh axis sizes must be >= 1, got "
                             f"{tuple(shape)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(
            zip(self.axis_names, (int(s) for s in shape)))
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # the device a tensor made on "cuda" reports
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device=None) -> Mesh:
    """The port's ``jaxcompat.make_mesh``: a :class:`Mesh` on ``device``
    (``"cuda"`` by default; raises without one unless ``device`` is
    given)."""
    return Mesh(axis_shapes, axis_names, resolve_device(device, "make_mesh"))


@dataclasses.dataclass(frozen=True)
class Permutation:
    """One ``ppermute`` round as index tensors on the mesh's device.

    ``src[p]`` is the peer that peer p receives from; ``received[p]`` is
    False for a peer that receives nothing (its ``src`` is 0 then).
    """

    src: torch.Tensor
    received: torch.Tensor


def permutation(pairs, size: int, device) -> Permutation:
    """The index tensors of a ``jax.lax.ppermute`` list of (src, dst)."""
    src = [0] * size
    received = [False] * size
    for s, d in pairs:
        if received[d]:
            raise ValueError(f"peer {d} receives twice in {pairs}")
        src[d], received[d] = s, True
    return Permutation(
        torch.tensor(src, dtype=torch.int64, device=device),
        torch.tensor(received, dtype=torch.bool, device=device))


def axis_index(size: int, device) -> torch.Tensor:
    """Every peer's index along the axis (``jax.lax.axis_index``), int32."""
    return torch.arange(size, dtype=torch.int32, device=device)


def ppermute(x: torch.Tensor, perm: Permutation) -> torch.Tensor:
    """``jax.lax.ppermute`` over the peer axis (dim -2) of ``x``: peer p
    gets the row of ``perm.src[p]``; peers that receive nothing get
    zeros, as in JAX."""
    got = x.index_select(-2, perm.src)
    return torch.where(perm.received[:, None], got, 0)


def psum(x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """``jax.lax.psum`` over the peer axis: the sum over ``dim``, in the
    input dtype.  The result is the same for every peer, so the peer
    axis is dropped.

    Bits as in JAX: the sum starts from +0.0, so -0.0 terms alone give
    +0.0, except over an axis of one peer, where ``psum`` is the
    identity.
    """
    if x.shape[dim] == 1:
        return x.select(dim, 0)
    return x.sum(dim=dim, dtype=x.dtype)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.all_gather(..., axis=-1, tiled=True)`` of per-peer rows
    ``(..., P, m)``: the ``(..., P * m)`` concatenation, peer 0 first."""
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))
