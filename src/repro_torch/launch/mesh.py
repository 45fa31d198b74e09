"""The port's host mesh for the LM serving path.

``make_host_mesh(model=P)`` is a :class:`repro_torch.core.mesh.Mesh` of
shape ``(1, P)`` over axes ``("data", "model")``: P virtual peers held
on ONE device as a tensor axis, as the ``DeviceEngine``'s are.  So
unlike the reference's (``launch/mesh.py``), it does not clamp P to a
device count: ``--model-par 16`` on one card runs 16 peers, every FD
merge round included.  The reference's production mesh
(``make_production_mesh``) waits for the multi-rank slice.
"""
from __future__ import annotations

from repro_torch.core.mesh import Mesh, resolve_device


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
