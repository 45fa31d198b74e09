"""What each gloo rank of chip_smoke.py's phase 16 runs on the card.

Not a script: ``chip_smoke.py`` spawns the ranks with
``repro_torch.launch.ranks.spawn_ranks(chip_train_ranks.run, 4,
args=(conf,))`` after building the kernels, and every rank imports this
module by name.  Each rank runs on ``cuda:0`` (one card shared by the
ranks' processes, which talk over gloo) and returns plain numbers; a
failed check raises.  ``tests/test_torch_train_ranks.py`` holds the same
code paths to the reference on the CPU; ``conf["device"] = "cpu"`` runs
this module there at a small ``conf``.

(a) training: ``launch.train.build`` over the group at ``--model-par
    2``, the (data 2, model 2) mesh, one peer a rank: each rank keeps
    its blocks of granite-moe-1b-a400m at full size and takes
    ``conf["steps"]`` steps of ``conf["batch"]`` x ``conf["seq"]``,
    each timed with the card synchronised; its loss and norm bits, its
    top-k launches a step, the bytes it delivered to other ranks a step
    beside the count the specs predict (:func:`predicted_bytes`), its
    ``max_memory_allocated``, and a digest of each block (the replicas
    of a leaf must agree bit for bit);
(b) the same arch at full width and ``conf["xcheck_layers"]`` layers
    in f32 with TF32 off: one step over the ranks, whose state the group
    then checkpoints to ``conf["ckpt"]``; rank 0 takes the same step on
    one process over a (2, 2) mesh of virtual peers (the same data
    shards, so the same MoE capacity) and measures the relative error
    of the loss and of the gradient's norm (AdamW's update does not
    see the gradient's scale, so the norm is what holds the reduce's
    sum over data ranks) and each parameter's relative L2 error after
    the update;
(c) ``serve decode`` (``launch.serve.decode_run``) over the group for
    each arch of ``conf["decode_archs"]``: its tokens, seconds, launches
    and delivered bytes.
"""
import dataclasses
import time

import torch
import torch.distributed as dist


def _require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def digest(t) -> int:
    """A 64-bit digest of a tensor's bits (position-weighted, wrapping
    int64 sums) for any element size."""
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[t.element_size()]
    b = t.detach().contiguous().view(bits).reshape(-1).to(torch.int64)
    w = torch.arange(b.numel(), device=t.device, dtype=torch.int64)
    return int(((b + 0x9E3779B9) * (w * 2 + 1)).sum())


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def predicted_bytes(params, specs, mesh, microbatches=1) -> int:
    """The bytes this rank delivers to other ranks in one train step,
    from the specs alone: each leaf gathered whole (each rank-spanning
    axis of each dim in turn: the piece held so far, to every other rank
    of the axis), each whole gradient (f32 under microbatches, else the
    parameter's dtype) summed over the data ranks (gathered from every
    one), the labelled-token counts and the loss over the data ranks,
    and the norm's partial sum over each rank axis in turn."""
    from repro_torch.optim import sharding as S
    rd = 1
    for ax in S.rank_axes(mesh, S.FSDP_AXES):
        rd *= ax.ranks
    sent = 0
    for name, p in params.named_parameters():
        piece = p.numel() * p.element_size()
        for d, entry in enumerate(specs[name]):
            for a in reversed(S._names(entry)):
                if a in mesh.shape and mesh.axis(a).ranks > 1:
                    r = mesh.axis(a).ranks
                    sent += piece * (r - 1)
                    piece *= r
        whole = 1
        for n in S.global_shape(p.shape, specs[name], mesh):
            whole *= n
        size = 4 if microbatches > 1 else p.element_size()
        sent += whole * size * (rd - 1)
    sent += 4 * microbatches * (rd - 1) + 4 * (rd - 1)
    sent += sum(4 * (ax.ranks - 1) for ax in S.rank_axes(mesh,
                                                         mesh.axis_names))
    return sent


def _train(rank, conf, dev):
    from repro_torch.data.pipeline import device_put_batch
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    group = dist.group.WORLD
    t0 = time.perf_counter()
    cfg, mesh, params, opt, step_fn, data = train.build(
        conf["arch"], smoke=conf.get("smoke", False), batch=conf["batch"],
        seq=conf["seq"], model_par=2, microbatches=1, remat="none",
        lr=3e-4, steps=conf["steps"], device=dev, group=group)
    _sync(dev)
    build_s = time.perf_counter() - t0
    _require(mesh.shape == {"data": 2, "model": 2}
             and mesh.ranks == {"data": 2, "model": 2},
             f"rank {rank}: mesh {mesh}")
    specs = step_fn.specs
    predicted = predicted_bytes(params, specs, mesh)
    losses, norms, step_s, sent, launches = [], [], [], [], []
    for i in range(conf["steps"]):
        batch = device_put_batch(data.batch_at(i), mesh)
        _sync(dev)
        dist.barrier()
        _build.reset_launches()
        before = mesh.sent_bytes
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        sent.append(mesh.sent_bytes - before)
        launches.append(dict(_build.LAUNCHES))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    want = {"topk": cfg.n_layers, "topk_select": 0, "merge": 0}
    for i, got in enumerate(launches):
        got = {k: got[k] for k in want}
        _require(dev.type != "cuda" or got == want,
                 f"rank {rank} step {i}: launches {got}, want {want}")
    import math
    _require(all(math.isfinite(x) for x in losses + norms),
             f"rank {rank}: losses {losses}, norms {norms}")
    out = {"losses": losses, "grad_norms": norms, "step_s": step_s,
           "sent_bytes": sent, "predicted_bytes": predicted,
           "launches": launches, "build_s": build_s,
           "coord": (mesh.axis("data").index, mesh.axis("model").index),
           "digests": {n: digest(p) for n, p in params.named_parameters()},
           "specs": specs, "n_layers": cfg.n_layers}
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return out


def _xcheck(rank, conf, dev):
    """(b): the f32 step over the ranks against one process."""
    from repro_torch.ckpt.checkpoint import save
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.data.pipeline import SyntheticLM, device_put_batch
    from repro_torch.launch.train import place_blocks
    from repro_torch.models import model as M
    from repro_torch.optim import sharding as S
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime.steps import make_train_step
    base = get_config(conf["arch"])
    if conf.get("smoke"):
        base = smoke_config(base)
    cfg = dataclasses.replace(base, n_layers=conf["xcheck_layers"],
                              param_dtype="float32",
                              compute_dtype="float32")
    ocfg = AdamWConfig(lr=3e-4, total_steps=2, warmup_steps=1)
    raw = SyntheticLM(cfg.vocab_size, conf["seq"], conf["batch"],
                      seed=4).batch_at(0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        mesh = Mesh((2, 2), ("data", "model"), dev,
                    group=dist.group.WORLD, ranks=(2, 2))

        def model():
            return M.init_params(torch.Generator(dev).manual_seed(0), cfg,
                                 max_seq=conf["seq"], device=dev)

        params = model()
        specs = place_blocks(params, cfg, mesh)
        opt = adamw_init(params, ocfg)
        step = make_train_step(cfg, ocfg, remat="none", mesh=mesh,
                               specs=specs)
        params, opt, m = step(params, opt, device_put_batch(raw, mesh))
        loss, norm = m["loss"].item(), m["grad_norm"].item()
        whole = {n: S.gather_leaf(p.detach(), specs[n], mesh)
                 for n, p in params.named_parameters()}
        save(conf["ckpt"], 1, (params, opt), mesh=mesh, specs=specs)
        saved = {"params": {n: digest(t) for n, t in whole.items()},
                 "m": {n: digest(S.gather_leaf(t, specs[n], mesh))
                       for n, t in opt.m.items()},
                 "v": {n: digest(S.gather_leaf(t, specs[n], mesh))
                       for n, t in opt.v.items()}}
        del params, opt
        out = {"loss": loss, "grad_norm": norm, "saved": saved}
        dist.barrier()
        if rank == 0:
            one = model()
            vmesh = Mesh((2, 2), ("data", "model"), dev)
            step1 = make_train_step(cfg, ocfg, remat="none", mesh=vmesh)
            one, _, m1 = step1(one, adamw_init(one, ocfg),
                               device_put_batch(raw, dev))
            l1, n1 = m1["loss"].item(), m1["grad_norm"].item()
            rel = {}
            for n, p in one.named_parameters():
                ref = p.detach().double()
                rel[n] = float((whole[n].double() - ref).norm()
                               / ref.norm().clamp_min(1e-30))
            out.update(one_loss=l1, loss_rel=abs(loss - l1) / abs(l1),
                       one_grad_norm=n1,
                       grad_norm_rel=abs(norm - n1) / abs(n1),
                       param_rel=rel)
        dist.barrier()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def restore_onto(rank, world, conf):
    """The f32 checkpoint of (b) restored onto this group's (world, 1)
    mesh; digests of the whole leaves."""
    from repro_torch.ckpt.checkpoint import restore
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.launch.train import place_blocks
    from repro_torch.models import model as M
    from repro_torch.optim import sharding as S
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    dev = _device(conf)
    base = get_config(conf["arch"])
    if conf.get("smoke"):
        base = smoke_config(base)
    cfg = dataclasses.replace(base, n_layers=conf["xcheck_layers"],
                              param_dtype="float32",
                              compute_dtype="float32")
    mesh = Mesh((world, 1), ("data", "model"), dev,
                group=dist.group.WORLD, ranks=(world, 1))
    params = M.init_params(torch.Generator(dev).manual_seed(1), cfg,
                           max_seq=conf["seq"], device=dev)
    specs = place_blocks(params, cfg, mesh)
    params, opt = restore(conf["ckpt"], 1, (params, adamw_init(
        params, AdamWConfig())), device=dev, mesh=mesh, specs=specs)
    return {"params": {n: digest(S.gather_leaf(p.detach(), specs[n], mesh))
                       for n, p in params.named_parameters()},
            "m": {n: digest(S.gather_leaf(t, specs[n], mesh))
                  for n, t in opt.m.items()},
            "v": {n: digest(S.gather_leaf(t, specs[n], mesh))
                  for n, t in opt.v.items()},
            "step": int(opt.step)}


def _decode(rank, argv, dev):
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import decode_run
    _sync(dev)
    dist.barrier()
    _build.reset_launches()
    out = decode_run(argv, group=dist.group.WORLD)
    _sync(dev)
    return {"tokens": out["tokens"], "t_prefill": out["t_prefill"],
            "t_decode": out["t_decode"],
            "sent_bytes": out["mesh"].sent_bytes,
            "launches": dict(_build.LAUNCHES)}


def _device(conf):
    dev = torch.device(conf.get("device", "cuda"))
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        from repro_torch.kernels import _build
        _build.ensure_built()
    else:
        torch.set_num_threads(1)
    return dev


def run(rank: int, world: int, conf: dict) -> dict:
    """Phase 16 on this rank: (a), (b), (c)."""
    dev = _device(conf)
    t0 = time.perf_counter()
    out = {"train": _train(rank, conf, dev)}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["xcheck"] = _xcheck(rank, conf, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["decode"] = {arch: _decode(rank, argv, dev)
                     for arch, argv in conf["decode"].items()}
    out["seconds"] = time.perf_counter() - t0
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return out
