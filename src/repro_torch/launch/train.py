"""End-to-end training driver of the port: data -> train_step ->
checkpoints, with fault tolerance (resume-from-latest, straggler
watchdog, recovery).

Runs on one device, the card unless ``--device cpu`` (``--device cuda``,
the default, raises without one); the CPU smoke is ``--smoke --device
cpu``.  ``--model-par`` is accepted: the reference clamps it to its
device count, so on one device the mesh is ``{'data': 1, 'model': 1}``
and the flag changes no arithmetic.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --steps 50 --batch 8 --seq 128 \\
      --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import time


def build(arch: str, *, smoke: bool, batch: int, seq: int, model_par: int,
          microbatches: int, remat: str, lr: float, steps: int,
          device=None):
    """(cfg, mesh, params, opt_state, step_fn, data): the model from
    seed 0 on ``device`` (the card unless the caller names another),
    AdamW's state, the train step and the synthetic data, as the
    reference's ``build`` makes them."""
    import torch

    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.core.mesh import Mesh, resolve_device
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime.steps import make_train_step

    cfg = get_config(arch)
    if smoke:
        cfg = smoke_config(cfg)
    device = resolve_device(device, "train")
    del model_par                        # clamped to the one device
    mesh = Mesh((1, 1), ("data", "model"), device)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(steps // 20, 1))
    params = M.init_params(torch.Generator(device).manual_seed(0), cfg,
                           max_seq=max(seq, 128), device=device)
    opt_state = adamw_init(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=microbatches,
                              remat=remat)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       global_batch=batch)
    return cfg, mesh, params, opt_state, step_fn, data


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
    return ap.parse_args(argv)


def run(argv=None):
    """Train as ``main`` does; returns (losses, (params, opt_state))."""
    import torch

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import device_put_batch, \
        extra_model_inputs
    from repro_torch.models import model as M
    from repro_torch.runtime.ft import StragglerWatchdog, run_with_recovery

    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "train --device cuda (the default) needs a CUDA device and "
            "none is available; pass --device cpu to run the plain "
            "PyTorch path")
    device = torch.device(args.device)
    cfg, mesh, params, opt_state, step_fn, data = build(
        args.arch, smoke=args.smoke, batch=args.batch, seq=args.seq,
        model_par=args.model_par, microbatches=args.microbatches,
        remat=args.remat, lr=args.lr, steps=args.steps, device=device)
    print(f"arch={cfg.name} params={M.count_params(params):,} "
          f"mesh={dict(mesh.shape)} devices=1")

    mgr = None
    start = 0
    state = (params, opt_state)
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, save_every=args.ckpt_every)
        got_step, got = mgr.restore_latest(state, device=device)
        if got is not None:
            start, state = got_step, got
            print(f"resumed from step {start}")

    t0 = time.time()
    losses = []

    def one_step(step, st):
        params, opt_state = st
        raw = data.batch_at(step)
        raw = extra_model_inputs(cfg, raw)
        batch = device_put_batch(raw, device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])    # waits for the step's kernels
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  {dt:.1f}s")
        return params, opt_state

    wd = StragglerWatchdog(factor=20.0) if args.watchdog else None
    init = state
    state = run_with_recovery(
        one_step, state, n_steps=args.steps, ckpt_manager=mgr,
        restore_fn=((lambda: mgr.restore_latest(init, device=device))
                    if mgr else None),
        watchdog=wd, start_step=start)
    print(f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return losses, state


def main(argv=None):
    """The reference's driver: prints its lines, returns the losses."""
    return run(argv)[0]


if __name__ == "__main__":
    main()
