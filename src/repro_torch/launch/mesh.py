"""The port's meshes: the production mesh and the LM serving path's
host mesh.

``make_production_mesh`` is the reference's (``launch/mesh.py:22``):
(16, 16) over ``("data", "model")``, or (2, 16, 16) with a ``"pod"``
axis first.  Its peers are virtual on one device, or, given a process
group, one peer a rank where the group has a rank for each of the 256
(or 512) peers, as the reference's devices each hold one, else split
over the group's ranks along the outermost axis; it raises where the
ranks do not divide that axis, as the reference raises on too few
devices.

``make_host_mesh(model=P)`` is a :class:`repro_torch.core.mesh.Mesh` of
shape ``(1, P)`` over axes ``("data", "model")``: P virtual peers held
on ONE device as a tensor axis, as the ``DeviceEngine``'s are.  So
unlike the reference's (``launch/mesh.py``), it does not clamp P to a
device count: ``--model-par 16`` on one card runs 16 peers, every FD
merge round included.  Given a process group it lays the mesh over the
group's ranks: the model axis over the reference's clamp of P to the
rank count (or ``model_ranks``), the data axis over the rest.
"""
from __future__ import annotations

import math

from repro_torch.core.mesh import Mesh, resolve_device


def make_production_mesh(*, multi_pod: bool = False, group=None,
                         device=None) -> Mesh:
    """The reference's production mesh on ``device`` (the card unless
    the caller names another): its 256 (or 512) peers virtual on one
    device, or over ``group``'s ranks: one peer a rank when the group
    has as many ranks as the mesh has peers, else along the outermost
    axis (``"data"`` or ``"pod"``), each rank holding an equal block of
    it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ranks = None
    if group is not None:
        import torch.distributed as dist
        world = dist.get_world_size(group)
        if world == math.prod(shape):
            ranks = shape
        elif shape[0] % world:
            raise RuntimeError(
                f"{world} ranks do not divide the production mesh's "
                f"{axes[0]!r} axis of {shape[0]}")
        else:
            ranks = (world,) + (1,) * (len(shape) - 1)
    return Mesh(shape, axes, resolve_device(device, "make_production_mesh"),
                group=group, ranks=ranks)


def make_host_mesh(model: int = 1, *, cfg, device=None, group=None,
                   data=None, model_ranks=None) -> Mesh:
    """A ``(data, model)`` mesh over axes ``("data", "model")`` on
    ``device`` (the card unless the caller names another) for ``cfg``.

    On one process (``group=None``) its peers are virtual, ``data``
    (default 1) by ``model``.  Over ``group``'s R ranks, the model axis
    spans ``model_ranks`` of them, by default the reference's clamp of
    ``model`` to the device count (``src/repro/launch/mesh.py:36-44``),
    ``min(model, R)``, and the data axis the other R / model_ranks, one
    peer a data rank; ``model`` peers are spread over the model ranks.  A model axis that does not divide R
    raises (the reference would leave devices out).  Refuses a
    ``model`` that does not divide ``cfg.padded_vocab()``: each peer
    holds one equal shard of the vocabulary, and the FD top-k raises on
    a ragged one as the reference's does."""
    if model < 1:
        raise ValueError(f"make_host_mesh: model must be >= 1, got {model}")
    if cfg.padded_vocab() % model:
        raise ValueError(
            f"make_host_mesh: model={model} does not divide {cfg.name}'s "
            f"padded vocabulary of {cfg.padded_vocab()}")
    device = resolve_device(device, "make_host_mesh")
    if group is None:
        return Mesh((1 if data is None else data, model), ("data", "model"),
                    device)
    if data is not None:
        raise ValueError("make_host_mesh: over a group the data axis is "
                         "one peer a data rank; data= is for one process")
    import torch.distributed as dist
    world = dist.get_world_size(group)
    mr = max(1, min(model, world)) if model_ranks is None else model_ranks
    if world % mr:
        raise ValueError(f"make_host_mesh: a model axis over {mr} ranks "
                         f"does not divide {world} ranks")
    dr = world // mr
    return Mesh((dr, model), ("data", "model"), device, group=group,
                ranks=(dr, mr))
