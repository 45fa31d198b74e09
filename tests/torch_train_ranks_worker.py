"""What each gloo rank of ``tests/test_torch_train_ranks.py`` runs.

A module of its own (torch, numpy and the port only, no JAX): the
ranks are spawned processes that import their functions by name.
Every rank initialises the smoke model from seed 0 on the CPU (the
weights the test hands the reference), keeps its blocks of it over a
``(data, model)`` mesh of ranks, trains, and returns numpy outputs,
the whole parameters gathered back among them.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt.checkpoint import restore, save
from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core.mesh import Mesh
from repro_torch.data.pipeline import SyntheticLM, device_put_batch
from repro_torch.launch.serve import state_from_prefill
from repro_torch.launch.train import place_blocks
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import sharding as S
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.steps import make_serve_step, make_train_step

B, SEQ, MICRO, STEPS, MAX_SEQ = 8, 32, 2, 2, 64
OPT = dict(lr=3e-4, total_steps=STEPS, warmup_steps=1)
#: the decode: batch, prompt, tokens, k, vocabulary peers
DEC_B, DEC_PROMPT, DEC_GEN, DEC_K = 4, 8, 6, 5


def init(arch):
    """(cfg, the smoke model from seed 0 on the CPU)."""
    cfg = smoke_config(get_config(arch))
    return cfg, M.init_params(torch.Generator().manual_seed(0), cfg,
                              max_seq=MAX_SEQ, device="cpu")


def placed(arch, mesh):
    """(cfg, params holding this rank's blocks, specs, AdamW state)."""
    cfg, params = init(arch)
    specs = place_blocks(params, cfg, mesh)
    return cfg, params, specs, adamw_init(params, AdamWConfig(**OPT))


def gathered(params, state, specs, mesh):
    """The whole parameters and moments, numpy, by name."""
    def whole(t, name):
        return S.gather_leaf(t.detach(), specs[name], mesh).numpy()
    return ({n: whole(p, n) for n, p in params.named_parameters()},
            {n: whole(t, n) for n, t in state.m.items()},
            {n: whole(t, n) for n, t in state.v.items()})


def train_steps(arch, mesh, cfg, params, specs, state):
    """STEPS steps of 2 microbatches on SyntheticLM; (losses, norms, the
    f32 bits of both, this rank's delivered bytes)."""
    step = make_train_step(cfg, AdamWConfig(**OPT), microbatches=MICRO,
                           remat="none", mesh=mesh, specs=specs)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ,
                       global_batch=B)
    losses, norms = [], []
    mesh.sent_bytes = 0
    for i in range(STEPS):
        batch = (device_put_batch(data.batch_at(i), mesh,
                                  microbatches=MICRO) if mesh.multi_rank
                 else device_put_batch(data.batch_at(i), "cpu"))
        params, state, om = step(params, state, batch)
        losses.append(om["loss"].clone())
        norms.append(om["grad_norm"].clone())
    return params, state, {"loss": torch.stack(losses).numpy(),
                           "grad_norm": torch.stack(norms).numpy(),
                           "bytes": mesh.sent_bytes}


def train(rank, world, conf):
    """Each arch at each (data, model) rank layout of ``conf["layouts"]``
    (one peer a rank); with ``conf["ckpt"]`` = (dir, arch, layout) the
    state after the steps is saved there by the group."""
    torch.set_num_threads(1)
    out = {}
    for arch in conf["archs"]:
        for lay in conf["layouts"]:
            mesh = Mesh(lay, ("data", "model"), "cpu",
                        group=dist.group.WORLD, ranks=lay)
            cfg, params, specs, state = placed(arch, mesh)
            params, state, res = train_steps(arch, mesh, cfg, params, specs,
                                             state)
            res["params"], m, v = gathered(params, state, specs, mesh)
            res["block_shapes"] = {n: tuple(p.shape)
                                   for n, p in params.named_parameters()}
            if conf.get("ckpt") and conf["ckpt"][1:] == (arch, lay):
                save(conf["ckpt"][0], STEPS, (params, state), mesh=mesh,
                     specs=specs)
                res["m"], res["v"] = m, v
            out[(arch, lay)] = res
    return out


def masked_batch(cfg):
    """A batch whose labels are -1 on most of its first rows, so that
    the data ranks hold unequal counts of labelled tokens."""
    raw = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=B, seed=5).batch_at(0)
    labels = raw["labels"].copy()
    labels[:3, 4:] = -1
    labels[4, :] = -1
    return {"tokens": raw["tokens"], "labels": labels}


def masked(rank, world, conf):
    """One step of ``conf["arch"]`` on :func:`masked_batch` over this
    group's ``conf["layout"]``; (loss, gradient norm, the whole
    parameters)."""
    torch.set_num_threads(1)
    lay = conf["layout"]
    mesh = Mesh(lay, ("data", "model"), "cpu", group=dist.group.WORLD,
                ranks=lay)
    cfg, params, specs, state = placed(conf["arch"], mesh)
    step = make_train_step(cfg, AdamWConfig(**OPT), microbatches=MICRO,
                           remat="none", mesh=mesh, specs=specs)
    batch = device_put_batch(masked_batch(cfg), mesh, microbatches=MICRO)
    params, state, om = step(params, state, batch)
    return (om["loss"].numpy(), om["grad_norm"].numpy(),
            gathered(params, state, specs, mesh)[0])


def restore_onto(rank, world, conf):
    """Each checkpoint directory of ``conf["dirs"]`` restored onto this
    group's ``conf["layout"]`` mesh; the whole leaves gathered back."""
    torch.set_num_threads(1)
    lay = conf["layout"]
    mesh = Mesh(lay, ("data", "model"), "cpu", group=dist.group.WORLD,
                ranks=lay)
    out = {}
    for d in conf["dirs"]:
        cfg, params, specs, state = placed(conf["arch"], mesh)
        params, state = restore(d, STEPS, (params, state), device="cpu",
                                mesh=mesh, specs=specs)
        got = gathered(params, state, specs, mesh)
        out[d] = got + (int(state.step),)
    return out


def decode(cfg, params, mesh, tokens, noise):
    """The serve decode of ``tokens`` (this rank's rows) given each
    step's noise (this rank's rows): prefill under the mesh, then
    ``make_serve_step``; returns every data rank's tokens gathered."""
    with L.use_mesh(mesh):
        last, pstate = M.prefill(params, cfg, {"tokens": tokens})
        tok = M.argmax_vocab(last, cfg)[:, None].to(torch.int32)
    state = state_from_prefill(cfg, pstate, DEC_PROMPT + DEC_GEN)
    step = make_serve_step(cfg, mesh, k=DEC_K)
    out = [tok]
    for i in range(DEC_GEN - 1):
        tok, state = step(params, state, tok, None, noise=noise[i])
        out.append(tok)
    toks = torch.cat(out, dim=1)
    if mesh.multi_rank:
        toks = S.gather_leaf(toks, ("data", None), mesh)
    return toks.numpy()


def decode_ranks(rank, world, conf):
    """granite's smoke decode over a (2, 2) mesh of 4 ranks: each rank
    its model blocks of the parameters and its 2 rows of the prompt and
    of the reference's noise."""
    torch.set_num_threads(1)
    lay = conf["layout"]
    mesh = Mesh(lay, ("data", "model"), "cpu", group=dist.group.WORLD,
                ranks=lay)
    cfg, params = init(conf["arch"])
    place_blocks(params, cfg, mesh, axes=("model",))
    rows = S.shard_leaf(torch.arange(DEC_B), ("data",), mesh)
    tokens = torch.from_numpy(conf["tokens"])[rows]
    noise = torch.from_numpy(conf["noise"])[:, rows]
    return decode(cfg, params, mesh, tokens, noise)


def elastic(rank, world):
    """``make_elastic_mesh`` over the whole group at model 1."""
    from repro_torch.ckpt.elastic import make_elastic_mesh
    mesh = make_elastic_mesh(world, 1, group=dist.group.WORLD,
                             device="cpu")
    return None if mesh is None else (mesh.shape, mesh.rank)


class Failing(RuntimeError):
    pass


def recover(rank, world, conf):
    """``run_with_recovery`` over the group with a checkpoint every 2
    steps of a tiny state; ``conf["fail_at"]`` makes rank 1 fail there.
    Returns (the step every rank resumed from, the state's value)."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.runtime.ft import run_with_recovery
    mesh = Mesh((world,), ("data",), "cpu", group=dist.group.WORLD)
    mgr = CheckpointManager(conf["dir"], save_every=2, blocking=True,
                            mesh=mesh, specs={})
    like = {"w": torch.zeros(3)}
    start, got = mgr.restore_latest(like, device="cpu")
    state = like if got is None else got

    def step(i, st):
        """A step with a collective in it, as a train step has: the
        ranks' values summed over the group."""
        if rank == 1 and i == conf["fail_at"]:
            raise Failing(f"rank 1 fails at step {i}")
        return {"w": S.psum_axes(st["w"], mesh, mesh.axis_names) / world + 1}

    state = run_with_recovery(step, state, n_steps=conf["steps"],
                              ckpt_manager=mgr, start_step=start or 0,
                              mesh=mesh,
                              restore_fn=lambda: mgr.restore_latest(
                                  like, device="cpu"))
    return start, state["w"].numpy()
