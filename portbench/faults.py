"""Faults planted in the port's timed path, to show that the output check
catches them (``portbench/tests/test_portbench_runs.py`` on the CPU,
``portbench/controls.py --fault`` on the card).  Each is a context
manager that patches one function of the port and restores it:

* ``frozen``: the train step's AdamW update leaves the parameters and
  the moments as they were (a step that returns its state unchanged);
* ``half_batch``: the loss of a train step, or a stacked top-k call,
  computed over the first half of the batch only (the train step's mean
  taken over that half; the call's second half of answers copied from
  the first);
* ``no_exchange``: FD's merge rounds receive nothing from other peers
  (every list a peer would get arrives empty);
* ``altered``: the first value of the first answer of each stacked
  top-k call moved up by one ulp where FD produces it.
"""
from __future__ import annotations

import contextlib

TRAIN = ("frozen", "half_batch")
QUERY = ("half_batch", "no_exchange", "altered")


@contextlib.contextmanager
def _patched(module, name: str, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def planted(fault: str, kind: str):
    """The context manager that plants ``fault`` in a ``kind`` cell's
    path (``kind``: the traffic's driver, ``train`` or ``fd_query``)."""
    import torch

    from repro_torch.core import fd
    from repro_torch.runtime import steps

    if kind == "train" and fault == "frozen":
        def make(old):
            def update(grads, state, params, cfg, decay, **kw):
                return params, state, {
                    "grad_norm": torch.zeros(()), "lr": torch.zeros(())}
            return update
        return _patched(steps, "adamw_update", make)
    if kind == "train" and fault == "half_batch":
        def make(old):
            def loss_fn(params, cfg, batch, **kw):
                half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
                return old(params, cfg, half, **kw)
            return loss_fn
        return _patched(steps.M, "loss_fn", make)
    if kind == "fd_query" and fault == "half_batch":
        def make(old):
            def fd_topk(scores, k, mesh, axis="model", **kw):
                b = scores.shape[0]
                v, i = old(scores[:b - b // 2], k, mesh, axis, **kw)
                return (torch.cat([v, v[:b // 2]]),
                        torch.cat([i, i[:b // 2]]))
            return fd_topk
        return _patched(fd, "fd_topk", make)
    if kind == "fd_query" and fault == "no_exchange":
        def make(old):
            def ppermute_all(xs, perm, axis=None):
                return tuple(torch.full_like(x, float("-inf"))
                             if x.is_floating_point()
                             else torch.full_like(x, -1) for x in xs)
            return ppermute_all
        return _patched(fd.M, "ppermute_all", make)
    if kind == "fd_query" and fault == "altered":
        def make(old):
            def fd_topk_shard(*a, **kw):
                v, i = old(*a, **kw)
                v = v.clone()
                v[..., 0, 0] = torch.nextafter(
                    v[..., 0, 0], torch.tensor(float("inf"),
                                               device=v.device))
                return v, i
            return fd_topk_shard
        return _patched(fd, "fd_topk_shard", make)
    raise ValueError(f"no fault {fault!r} for a {kind} cell")
