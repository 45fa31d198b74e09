"""Elastic re-meshing: restore / reshard state onto a changed rank count.

The paper's churn handling at the granularity where ML systems churn:
hosts, between steps.  Checkpoints are layout-free (a global ``.npy`` a
leaf, ``ckpt/checkpoint.py``), so elasticity is: build the new mesh,
compute the partition specs of the same parameter tree for it, and cut
each rank's blocks.  A checkpoint written by 4 ranks restores onto 2
ranks or onto one process, and the reverse.

``make_elastic_mesh`` picks the largest power-of-two data axis that
fits the surviving ranks (the model axis is fixed by the parallelism
plan; losing model-axis peers needs a smaller model axis, which the
same machinery handles as long as divisibility holds).
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.core.mesh import Mesh, resolve_device
from repro_torch.optim.sharding import param_specs, shard_leaf


def largest_pow2_leq(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def make_elastic_mesh(n_ranks: int, model_size: int, *, group=None,
                      device=None) -> Optional[Mesh]:
    """A ``(data, model)`` mesh with data the largest power of two that
    fits ``n_ranks // model_size``: one peer a rank over the first
    ``data * model_size`` ranks of ``group`` (a new subgroup when that
    is fewer than the group's; every rank of the group calls this, and
    a rank left out gets None), or virtual peers on one process when
    ``group`` is None.  Raises where the ranks cannot host the model
    axis, as the reference does."""
    if n_ranks // model_size < 1:
        raise ValueError(
            f"{n_ranks} ranks cannot host model axis {model_size}")
    data = largest_pow2_leq(n_ranks // model_size)
    device = resolve_device(device, "make_elastic_mesh")
    shape = (data, model_size)
    if group is None:
        return Mesh(shape, ("data", "model"), device)
    import torch.distributed as dist
    members = dist.get_process_group_ranks(group)
    if n_ranks > len(members):
        raise ValueError(f"{n_ranks} ranks asked of a group of "
                         f"{len(members)}")
    used = members[:data * model_size]
    sub = group if len(used) == len(members) else dist.new_group(
        ranks=used, backend="gloo")
    if dist.get_rank() not in used:
        return None
    return Mesh(shape, ("data", "model"), device, group=sub, ranks=shape)


def reshard_tree(tree: Any, cfg, mesh: Mesh, specs: Optional[Any] = None
                 ) -> Any:
    """This rank's blocks of a whole (possibly host-resident) tree
    ``{name: tensor}`` on ``mesh``'s device: ``specs`` defaults to the
    parameter specs of the tree for ``mesh``."""
    if specs is None:
        specs = param_specs(tree, cfg, mesh)
    return {n: shard_leaf(x, specs[n], mesh).to(mesh.device, copy=True)
            for n, x in tree.items()}
