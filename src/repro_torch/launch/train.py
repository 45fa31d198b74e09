"""End-to-end training driver of the port: data -> train_step ->
checkpoints, with fault tolerance (resume-from-latest, straggler
watchdog, recovery).

Runs on the card unless ``--device cpu`` (``--device cuda``, the
default, raises without one).  With ``--ranks 1`` (the default) it is
one process on one device, and ``--model-par`` is clamped to that one
device as the reference clamps it: the mesh is ``{'data': 1, 'model':
1}``.  ``--ranks R`` starts R gloo ranks (``launch/ranks.py``); the mesh
is ``(R // M, M)`` over ``("data", "model")``, M the reference's clamp
of ``--model-par`` to R, one peer a rank (``launch/mesh.py``).  Every
rank initialises the model from seed 0 and keeps its blocks of it
(``optim/sharding.py::param_specs``), with AdamW's moments placed as
the parameters; each step gathers the parameters over the data ranks
(a leaf the specs put over ``model`` stays its model block), computes
on the rank's rows of the batch with the products split over the model
ranks, and reduce-scatters the gradients over the data ranks
(``runtime/steps.py::make_train_step``); checkpoints keep the global
layout.  Rank 0 prints the reference's lines.  On one card the ranks
share it.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --steps 50 --batch 8 --seq 128 \\
      --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --ranks 4 --model-par 2 --steps 3 --microbatches 2
"""
from __future__ import annotations

import argparse
import math
import time


def build(arch: str, *, smoke: bool, batch: int, seq: int, model_par: int,
          microbatches: int, remat: str, lr: float, steps: int,
          device=None, group=None):
    """(cfg, mesh, params, opt_state, step_fn, data): the model from
    seed 0 on ``device`` (the card unless the caller names another),
    AdamW's state, the train step and the synthetic data, as the
    reference's ``build`` makes them.  Over ``group``'s ranks, ``params``
    and the moments hold this rank's blocks, and ``step_fn.specs`` the
    parameters' specs."""
    import torch

    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.core.mesh import Mesh, resolve_device
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime.steps import make_train_step

    cfg = get_config(arch)
    if smoke:
        cfg = smoke_config(cfg)
    device = resolve_device(device, "train")
    if group is None:                    # clamped to the one device
        mesh = Mesh((1, 1), ("data", "model"), device)
    else:
        import torch.distributed as dist
        mesh = make_host_mesh(max(1, min(model_par,
                                         dist.get_world_size(group))),
                              cfg=cfg, device=device, group=group)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(steps // 20, 1))
    params = M.init_params(torch.Generator(device).manual_seed(0), cfg,
                           max_seq=max(seq, 128), device=device)
    specs = None
    if mesh.multi_rank:
        specs = place_blocks(params, cfg, mesh)
    opt_state = adamw_init(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=microbatches,
                              remat=remat, mesh=mesh, specs=specs)
    step_fn.specs = specs
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       global_batch=batch)
    return cfg, mesh, params, opt_state, step_fn, data


def place_blocks(params, cfg, mesh, axes=None) -> dict:
    """Keep this rank's blocks of ``params`` (in place, each a copy, so
    the whole leaf is freed) over the rank-spanning axes of their specs
    among ``axes`` (all of them by default; serving keeps the model
    blocks, whole over the data axes, with ``("model",)``); returns the
    parameters' specs."""
    from repro_torch.optim.sharding import param_specs, shard_leaf
    specs = param_specs(params, cfg, mesh)
    for name, p in params.named_parameters():
        p.data = shard_leaf(p.data, specs[name], mesh, axes=axes).to(
            mesh.device, copy=True)
    return specs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=("none", "full", "dots"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--watchdog", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains; cuda raises without a "
                         "CUDA device")
    ap.add_argument("--ranks", type=int, default=1,
                    help="gloo ranks to train over (one process: 1)")
    return ap.parse_args(argv)


def _rank_run(rank: int, world: int, argv) -> list:
    """What each rank of ``--ranks`` runs: :func:`run` over the group."""
    import torch.distributed as dist
    _share_cores(world)
    return run(argv, group=dist.group.WORLD)[0]


def _share_cores(world: int) -> None:
    """A rank's share of the host's cores for its CPU work, so that the
    ranks of one machine do not oversubscribe it."""
    import os

    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))


def run(argv=None, *, group=None):
    """Train as ``main`` does; returns (losses, (params, opt_state)).
    With ``--ranks R`` > 1 (and no ``group``) it starts the R ranks and
    returns (rank 0's losses, None); a rank runs it with its ``group``
    and gets its own blocks."""
    import torch

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import device_put_batch, \
        extra_model_inputs
    from repro_torch.optim.sharding import global_shape
    from repro_torch.runtime.ft import StragglerWatchdog, run_with_recovery

    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "train --device cuda (the default) needs a CUDA device and "
            "none is available; pass --device cpu to run the plain "
            "PyTorch path")
    if args.ranks < 1:
        raise ValueError(f"--ranks must be >= 1, got {args.ranks}")
    if group is None and args.ranks > 1:
        from repro_torch.launch.ranks import RANK_TIMEOUT_S, spawn_ranks
        if args.device == "cuda":
            from repro_torch.kernels import _build
            _build.ensure_built()        # the ranks load the built kernels
        import sys
        argv = list(sys.argv[1:] if argv is None else argv)
        outs = spawn_ranks(_rank_run, args.ranks, args=(argv,),
                           timeout=RANK_TIMEOUT_S)
        return outs[0], None
    device = torch.device(args.device)
    if group is not None and device.type == "cuda":
        import torch.distributed as dist
        device = torch.device("cuda", dist.get_rank(group)
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    cfg, mesh, params, opt_state, step_fn, data = build(
        args.arch, smoke=args.smoke, batch=args.batch, seq=args.seq,
        model_par=args.model_par, microbatches=args.microbatches,
        remat=args.remat, lr=args.lr, steps=args.steps, device=device,
        group=group)
    specs = step_fn.specs
    lead = not mesh.multi_rank or mesh.rank == 0

    def say(line):
        if lead:
            print(line, flush=True)

    n_params = sum(math.prod(global_shape(p.shape, specs[n], mesh)
                             if specs else p.shape)
                   for n, p in params.named_parameters())
    say(f"arch={cfg.name} params={n_params:,} mesh={dict(mesh.shape)} "
        f"devices={args.ranks}")

    mgr = None
    start = 0
    state = (params, opt_state)
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, save_every=args.ckpt_every,
                                mesh=mesh, specs=specs)
        got_step, got = mgr.restore_latest(state, device=device)
        if got is not None:
            start, state = got_step, got
            say(f"resumed from step {start}")

    t0 = time.time()
    losses = []

    def one_step(step, st):
        params, opt_state = st
        raw = data.batch_at(step)
        raw = extra_model_inputs(cfg, raw)
        batch = (device_put_batch(raw, mesh, microbatches=args.microbatches)
                 if mesh.multi_rank else device_put_batch(raw, device))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])    # waits for the step's kernels
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            say(f"step {step:5d}  loss {loss:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                f"lr {float(metrics['lr']):.2e}  {dt:.1f}s")
        return params, opt_state

    wd = StragglerWatchdog(factor=20.0) if args.watchdog else None
    init = state
    state = run_with_recovery(
        one_step, state, n_steps=args.steps, ckpt_manager=mgr,
        restore_fn=((lambda: mgr.restore_latest(init, device=device))
                    if mgr else None),
        watchdog=wd, start_step=start, mesh=mesh)
    if losses:
        say(f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return losses, state


def main(argv=None):
    """The reference's driver: prints its lines, returns the losses."""
    return run(argv)[0]


if __name__ == "__main__":
    main()
