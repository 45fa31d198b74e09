"""Start a group of gloo ranks on this machine and collect what each
returns.

    from repro_torch.launch.ranks import spawn_ranks
    outs = spawn_ranks(fn, 4, args=(...,), timeout=300)

``fn(rank, world, *args)`` runs in ``world`` fresh processes (the
``spawn`` start method: the caller may already hold a CUDA context),
each joined to one default ``torch.distributed`` group on the gloo
backend through a ``FileStore`` in a new temporary directory (no
network), with a collective timeout of ``COLLECTIVE_TIMEOUT_S`` seconds
in place of gloo's 30 minutes.  ``fn`` must be importable by name: a
module-level function of an importable module, never ``__main__``'s.
What it returns is saved with ``torch.save`` and handed back, rank 0
first; the ranks then meet at a barrier before the group is torn down,
so that no rank closes its connections while a peer still exchanges over
them (gloo aborts a process whose peer left mid-collective).  When a
rank fails, the others are killed and a ``RuntimeError`` raised here
holds each failed rank's traceback, the first to fail first (a rank
whose peer died fails too, a little later); when ``timeout`` seconds
pass first, every rank is killed and ``TimeoutError`` raised.  Build the
CUDA kernels before spawning (``kernels._build.ensure_built``): the
ranks then load the built libraries.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback


#: gloo's collective timeout in the ranks (its default is 30 minutes)
COLLECTIVE_TIMEOUT_S = 60

#: seconds before the launchers' ``--ranks`` groups are ended
RANK_TIMEOUT_S = 3600.0


def _rank_main(rank: int, fn, world: int, store: str, out_dir: str,
               args: tuple) -> None:
    import torch
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"{time.time():.6f}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _failures(out_dir: str, world: int) -> str:
    """Every failed rank's traceback, the first to fail first."""
    found = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                when, _, tb = f.read().partition("\n")
            found.append((float(when), r, tb))
    return "\n".join(f"-- rank {r}:\n{tb}" for _, r, tb in sorted(found))


def spawn_ranks(fn, world: int, args: tuple = (), *,
                timeout: float = 300.0) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; return
    each rank's result, rank 0 first (see the module docstring)."""
    import torch
    import torch.multiprocessing as mp
    if world < 1:
        raise ValueError(f"spawn_ranks: world must be >= 1, got {world}")
    tmp = tempfile.mkdtemp(prefix="repro_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, os.path.join(tmp, "store"), tmp,
                              tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while True:
            try:
                if ctx.join(timeout=max(0.0, min(
                        1.0, deadline - time.monotonic()))):
                    break
            except Exception as e:   # a rank died: the others are killed
                raise RuntimeError(
                    f"spawn_ranks: a rank of {fn.__qualname__} failed\n"
                    f"{_failures(tmp, world) or e}") from e
            if time.monotonic() >= deadline:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.kill()
                for proc in ctx.processes:
                    proc.join()
                raise TimeoutError(f"spawn_ranks: {world} ranks of "
                                   f"{fn.__qualname__} did not end in "
                                   f"{timeout} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
