"""Atomic, asynchronous checkpointing of the port's training state
(one ``.npy`` a leaf), in the reference's layout.

Layout:    <dir>/step_00000123/ {tree.json, leaf_00000.npy, ...}
Atomicity: write to ``step_N.tmp`` then ``os.rename`` (POSIX-atomic).
Async:     a snapshot is taken synchronously (a device -> host copy of
           every leaf), the file write happens on a daemon thread;
           ``wait()`` joins.
Keep-N:    older complete checkpoints beyond ``keep`` are deleted.
Restore:   leaves are loaded onto an explicit device, each shape checked
           against the target structure.
Ranks:     a tree sharded over a mesh of ranks is saved in the same
           global layout (rank 0 writes, a barrier follows) and each
           rank restores its blocks, so a checkpoint written by one
           mesh restores onto another (``ckpt/elastic.py``).

A tree is a nesting of dicts, lists, tuples (``AdamWState`` too) and
``nn.Module``s (an ``LM``: its ``state_dict``) over tensors; its leaves
are written in that order.  numpy has no bfloat16: a bf16 leaf is
written as its ``int16`` bits, ``tree.json`` records every leaf's dtype,
and restore gives the same bits back.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch
from torch import nn


def _flatten(tree, leaves: List[torch.Tensor], names=None, name=None):
    """Append ``tree``'s tensor leaves to ``leaves`` in order (and to
    ``names`` each leaf's name: its module or dict key, None under a
    list or tuple); returns a description of its structure
    (``tree.json``'s ``treedef``)."""
    if isinstance(tree, nn.Module):
        sd = tree.state_dict()
        leaves.extend(sd.values())
        if names is not None:
            names.extend(sd)
        return {"module": type(tree).__name__, "keys": list(sd)}
    if isinstance(tree, dict):
        return {"dict": {k: _flatten(v, leaves, names, k)
                         for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [_flatten(v, leaves, names)
                                      for v in tree]}
    if torch.is_tensor(tree):
        leaves.append(tree)
        if names is not None:
            names.append(name)
        return "*"
    raise TypeError(f"checkpoint: no leaf or node of type {type(tree)}")


def _leaf_specs(tree, specs) -> list:
    """Each leaf's spec in flatten order: ``specs[name]`` for a leaf
    named there (a parameter, or a moment keyed by its parameter's
    name), else whole (a spec of ``None``s)."""
    leaves: List[torch.Tensor] = []
    names: list = []
    _flatten(tree, leaves, names)
    return [specs[n] if specs is not None and n in specs
            else (None,) * x.dim() for x, n in zip(leaves, names)]


def _over_ranks(mesh) -> bool:
    return mesh is not None and mesh.multi_rank


def _is_writer(mesh) -> bool:
    return not _over_ranks(mesh) or mesh.rank == 0


def _unflatten(like, leaves, device):
    """``like``'s structure over the next tensors of the iterator
    ``leaves``; a module is loaded in place (``load_state_dict``, after
    ``.to(device)``) and returned."""
    if isinstance(like, nn.Module):
        like.to(device)
        keys = list(like.state_dict())
        like.load_state_dict({k: next(leaves) for k in keys})
        return like
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, device) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        vals = [_unflatten(v, leaves, device) for v in like]
        return (type(like)(*vals) if hasattr(like, "_fields")
                else type(like)(vals))
    return next(leaves)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a copy even of a CPU tensor, which training
    goes on to update in place), bf16 as its int16 bits."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy()


def save(directory: str, step: int, tree: Any, *, blocking: bool = True,
         mesh=None, specs=None) -> Optional[threading.Thread]:
    """Write ``tree`` at ``<directory>/step_{step:08d}`` atomically.

    Over a mesh whose axes span ranks, ``tree`` holds this rank's
    blocks and ``specs`` (``{parameter name: spec}``) says how each
    named leaf is cut; every rank calls ``save``.  The layout is the
    one-process one, a global ``.npy`` a leaf: each leaf is gathered
    whole (``optim/sharding.py::gather_leaf``), one at a time, rank 0
    keeps its host copy and writes them all, and every rank waits at a
    barrier until the write is done (``blocking`` is then ignored)."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    leaves: List[torch.Tensor] = []
    treedef = _flatten(tree, leaves)
    if _over_ranks(mesh):
        from repro_torch.optim.sharding import gather_leaf
        host_leaves = []
        for x, spec in zip(leaves, _leaf_specs(tree, specs)):
            whole = gather_leaf(x.detach(), spec, mesh)
            if mesh.rank == 0:
                host_leaves.append(_to_host(whole))
            del whole
    else:
        # synchronous device->host snapshot (cheap vs the file write)
        host_leaves = [_to_host(x) for x in leaves]
    spec = {"n_leaves": len(host_leaves), "treedef": json.dumps(treedef),
            "step": step,
            "dtypes": [str(x.dtype).removeprefix("torch.") for x in leaves]}

    def _write():
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for i, a in enumerate(host_leaves):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), a)
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(spec, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if _over_ranks(mesh):
        import torch.distributed as dist
        if mesh.rank == 0:
            _write()
        dist.barrier(group=mesh.group)
        return None
    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _finished(directory: str) -> List[int]:
    """The steps of the complete checkpoints in ``directory``, sorted."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name[5:]) for name in os.listdir(directory)
                  if name.startswith("step_") and not name.endswith(".tmp")
                  and os.path.exists(os.path.join(directory, name,
                                                  "tree.json")))


def latest_step(directory: str) -> Optional[int]:
    steps = _finished(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, tree_like: Any, *, device,
            mesh=None, specs=None) -> Any:
    """Load a checkpoint into the structure of ``tree_like`` on
    ``device``: tensors come back as new tensors in their saved dtype
    and bits, a module is loaded in place.  A leaf whose shape differs
    from ``tree_like``'s raises ``ValueError``.

    Over a mesh whose axes span ranks, ``tree_like`` holds blocks and
    ``specs`` cuts them: each rank reads the global leaves and keeps its
    blocks (``optim/sharding.py::shard_leaf``), so a checkpoint restores
    onto any mesh whose specs fit its leaves, one process included."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "tree.json")) as f:
        spec = json.load(f)
    leaves_like: List[torch.Tensor] = []
    _flatten(tree_like, leaves_like)
    if spec["n_leaves"] != len(leaves_like):
        raise ValueError(f"checkpoint holds {spec['n_leaves']} leaves, "
                         f"expected {len(leaves_like)}")
    if _over_ranks(mesh):
        from repro_torch.optim.sharding import global_shape, shard_leaf
        leaf_specs = _leaf_specs(tree_like, specs)
    out = []
    for i, like in enumerate(leaves_like):
        a = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        want = tuple(like.shape)
        if _over_ranks(mesh):
            want = global_shape(want, leaf_specs[i], mesh)
        if tuple(a.shape) != want:
            raise ValueError(f"checkpoint leaf shape {a.shape} != expected "
                             f"{want}")
        t = torch.from_numpy(a)
        if spec["dtypes"][i] == "bfloat16":
            t = t.view(torch.bfloat16)
        if _over_ranks(mesh):
            t = shard_leaf(t, leaf_specs[i], mesh)
        out.append(t.to(device, copy=True))
        del a, t
    return _unflatten(tree_like, iter(out), torch.device(device))


class CheckpointManager:
    """save-every-N + keep-last-K + async writes + resume-from-latest."""

    def __init__(self, directory: str, *, save_every: int = 100,
                 keep: int = 3, blocking: bool = False, mesh=None,
                 specs=None):
        self.directory = directory
        self.save_every = save_every
        self.keep = keep
        self.blocking = blocking
        self.mesh = mesh if _over_ranks(mesh) else None
        self.specs = specs
        self._thread: Optional[threading.Thread] = None

    def maybe_save(self, step: int, tree: Any, *, force: bool = False):
        """Over ranks every rank calls this (the leaves are gathered
        collectively); rank 0 alone lists, writes and deletes."""
        if not force and (step == 0 or step % self.save_every):
            return False
        self.wait()
        writer = _is_writer(self.mesh)
        before = _finished(self.directory) if writer else []
        self._thread = save(self.directory, step, tree,
                            blocking=self.blocking, mesh=self.mesh,
                            specs=self.specs)
        if writer:
            self._gc(before, step)
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self, before: List[int], step: int):
        """Keep the newest ``keep - 1`` of the checkpoints that were
        complete before the write of ``step`` started, leaving ``step``
        itself out (a forced re-save of the last step rewrites it), so
        that with the new one ``keep`` remain.  The reference's ``_gc``
        (``src/repro/ckpt/checkpoint.py:123``) lists the directory after
        the write started: a write already finished is counted among the
        ``keep - 1``, so only ``keep - 1`` remain, every time when
        ``blocking`` (reference fault 3)."""
        if not self.keep:
            return
        older = [s for s in before if s != step]
        for s in older[:max(len(older) - (self.keep - 1), 0)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, tree_like: Any, *, device):
        """(step, ``restore(...)``) of the newest complete checkpoint on
        ``device``, or (None, None)."""
        self.wait()
        step = latest_step(self.directory) if _is_writer(self.mesh) \
            else None
        if self.mesh is not None:        # rank 0's step, on every rank
            import torch.distributed as dist
            got = [step]
            dist.broadcast_object_list(
                got, src=dist.get_global_rank(self.mesh.group, 0),
                group=self.mesh.group)
            step = got[0]
        if step is None:
            return None, None
        return step, restore(self.directory, step, tree_like, device=device,
                             mesh=self.mesh, specs=self.specs)
