"""The port's meshes: the production mesh and the LM serving path's
host mesh.

``make_production_mesh`` is the reference's (``launch/mesh.py:22``):
(16, 16) over ``("data", "model")``, or (2, 16, 16) with a ``"pod"``
axis first.  Its peers are virtual on one device, or, given a process
group, split over the group's ranks along the outermost axis; it raises
where the ranks do not divide that axis, as the reference raises on too
few devices.

``make_host_mesh(model=P)`` is a :class:`repro_torch.core.mesh.Mesh` of
shape ``(1, P)`` over axes ``("data", "model")``: P virtual peers held
on ONE device as a tensor axis, as the ``DeviceEngine``'s are.  So
unlike the reference's (``launch/mesh.py``), it does not clamp P to a
device count: ``--model-par 16`` on one card runs 16 peers, every FD
merge round included.
"""
from __future__ import annotations

from repro_torch.core.mesh import Mesh, resolve_device


def make_production_mesh(*, multi_pod: bool = False, group=None,
                         device=None) -> Mesh:
    """The reference's production mesh on ``device`` (the card unless
    the caller names another): its 256 (or 512) peers virtual on one
    device, or over ``group``'s ranks along the outermost axis (``"data"``
    or ``"pod"``), each rank holding an equal block of it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ranks = None
    if group is not None:
        import torch.distributed as dist
        world = dist.get_world_size(group)
        if shape[0] % world:
            raise RuntimeError(
                f"{world} ranks do not divide the production mesh's "
                f"{axes[0]!r} axis of {shape[0]}")
        ranks = (world,) + (1,) * (len(shape) - 1)
    return Mesh(shape, axes, resolve_device(device, "make_production_mesh"),
                group=group, ranks=ranks)


def make_host_mesh(model: int = 1, *, cfg, device=None) -> Mesh:
    """A ``(1, model)`` mesh of virtual peers on ``device`` (the card
    unless the caller names another) for ``cfg``'s decode.  Refuses a
    ``model`` that does not divide ``cfg.padded_vocab()``: each peer
    holds one equal shard of the vocabulary, and the FD top-k raises on
    a ragged one as the reference's does."""
    if model < 1:
        raise ValueError(f"make_host_mesh: model must be >= 1, got {model}")
    if cfg.padded_vocab() % model:
        raise ValueError(
            f"make_host_mesh: model={model} does not divide {cfg.name}'s "
            f"padded vocabulary of {cfg.padded_vocab()}")
    return Mesh((1, model), ("data", "model"),
                resolve_device(device, "make_host_mesh"))
