"""What each gloo rank of ``tests/test_torch_model_ranks.py`` runs.

A module of its own (torch, numpy and the port only, no JAX): the
ranks are spawned processes that import their functions by name.  The
inputs are made from numpy seeds, so the test process makes the same
ones for the one-process port.  Every function returns numpy outputs.
"""
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core import mesh as C
from repro_torch.core.mesh import Mesh
from repro_torch.launch.train import place_blocks
from repro_torch.models import attention as A
from repro_torch.models import griffin as G
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim import sharding as S

import torch_train_ranks_worker as TW

#: the module cases: (name, arch, model ranks); each runs at smoke size
#: in f64 on one (1, m) mesh of ranks, or on one process without a mesh
MODULES = (("ffn_swiglu", "qwen2-0.5b", 2),
           ("ffn_gelu", "whisper-large-v3", 2),
           ("rwkv_cmix", "rwkv6-3b", 2),
           ("gqa_kv_tp", "qwen2-0.5b", 2),
           ("gqa_whole_kv", "qwen2-0.5b", 4),
           ("gqa_uneven_kv", "phi3-medium-14b", 4),
           ("rglru", "recurrentgemma-2b", 2),
           ("moe", "granite-moe-1b-a400m", 2),
           ("moe_shared", "moonshot-v1-16b-a3b", 2),
           ("vocab_tied", "qwen2-0.5b", 2),
           ("vocab_untied", "phi3-medium-14b", 2))
MOD_B, MOD_S = 2, 16
#: a case's changes to the smoke config: 12 heads over 3 KV heads at 4
#: model ranks give each rank 3 query heads that read 2 KV heads
#: unevenly, as phi3-medium-14b's 40 over 10 do at 4 or 8 model ranks
OVERRIDES = {"gqa_uneven_kv": {"n_heads": 12, "n_kv_heads": 3}}


def mesh_of(lay, world):
    """A (data, model) mesh over this group's ranks, one peer a rank."""
    return Mesh(lay, ("data", "model"), "cpu", group=dist.group.WORLD,
                ranks=lay)


def f64_model(arch, **changes):
    """(cfg, the smoke model from seed 0 in f64), ``changes`` made to
    the smoke config."""
    import dataclasses
    cfg = dataclasses.replace(smoke_config(get_config(arch)), **changes)
    return cfg, M.init_params(torch.Generator().manual_seed(0), cfg,
                              max_seq=64, device="cpu").double()


def _arr(shape, seed, dtype=np.float64):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(dtype))


def module_case(name, arch, mesh=None):
    """Forward and backward of one module at smoke size in f64 on this
    rank's blocks (on the whole leaves without ``mesh``): {"y": the
    output, gathered to the global layout, "dx": the input's gradient,
    "g/<leaf>": each leaf's gradient gathered to the global layout,
    "n_used": how many leaves the case differentiates}."""
    cfg, params = f64_model(arch, **OVERRIDES.get(name, {}))
    specs = (place_blocks(params, cfg, mesh, axes=("model",))
             if mesh is not None else None)
    d = cfg.d_model
    x = _arr((MOD_B, MOD_S, d), 1).requires_grad_(True)
    block = params.layers[0]
    with L.use_mesh(mesh):
        if name.startswith("ffn"):
            prefix, leaves = "layers.0.ffn.", block.ffn
            y = L.apply_ffn(leaves, x, cfg.act, cfg)
        elif name == "rwkv_cmix":
            prefix, leaves = "layers.0.ffn.", block.ffn
            y, _ = L.apply_rwkv_cmix(leaves, x, _arr((MOD_B, 1, d), 2), cfg)
        elif name.startswith("gqa"):
            prefix, leaves = "layers.0.mixer.", block.mixer
            pos = M.make_positions(cfg, MOD_B, MOD_S)
            y, _ = A.gqa_attention(leaves, x, cfg, positions=pos,
                                   mode="train", q_block=8, kv_block=8)
        elif name == "rglru":
            block = params.layers[1]          # the smoke config's 2 RG-LRU
            prefix, leaves = "layers.1.mixer.", block.mixer
            lw = G.width_split(cfg)[1]
            y, _ = G.apply_griffin(leaves, x, cfg, state=(
                _arr((MOD_B, lw), 3) if mesh is None else S.shard_leaf(
                    _arr((MOD_B, cfg.recurrent.lru_width), 3), (None, "model"),
                    mesh),
                torch.zeros((MOD_B, cfg.recurrent.conv_width - 1, lw),
                            dtype=torch.float64)))
        elif name.startswith("moe"):
            prefix, leaves = "layers.0.ffn.", block.ffn
            y, aux = MOE.apply_moe(leaves, x, cfg)
            y = y + aux
        else:                                     # embedding, logits, CE
            prefix, leaves = "", params
            tokens = torch.from_numpy(np.random.default_rng(4).integers(
                0, cfg.padded_vocab(), (MOD_B, MOD_S)).astype(np.int32))
            labels = torch.from_numpy(np.random.default_rng(5).integers(
                -1, cfg.padded_vocab(), (MOD_B, MOD_S)).astype(np.int32))
            emb = M.embed_tokens(params, cfg, tokens)
            logits = M.logits_fn(params, cfg, x)
            lse, picked = M.ce_terms(logits, labels, cfg)
            ce = ((lse - picked) * (labels >= 0)).sum()
            y = emb + ce
            ax = M.vocab_split(cfg)[0]
            logits_whole = (C.gather_dim(logits.detach(), ax, -1)
                            if ax is not None else logits.detach())
        gy = _arr(tuple(y.shape), 6)
        (y * gy).sum().backward()
    out = {"y": y.detach().numpy(), "dx": x.grad.numpy()}
    if name.startswith("vocab"):
        out["logits"] = logits_whole.numpy()
    used = 0
    for leaf, p in params.named_parameters():
        if not leaf.startswith(prefix) or p.grad is None:
            continue
        used += 1
        g = p.grad
        if mesh is not None:
            g = S.gather_leaf(g, specs[leaf], mesh, axes=("model",))
        out[f"g/{leaf}"] = g.numpy()
    out["n_used"] = used
    return out


def modules(rank, world, conf):
    """Every case of ``conf["cases"]`` over this group's (1, m) mesh."""
    torch.set_num_threads(1)
    mesh = mesh_of((1, world), world)
    return {name: module_case(name, arch, mesh)
            for name, arch, _ in conf["cases"]}


# --------------------------------------------------------------------------
# the step-1 collectives and reduce_leaf
# --------------------------------------------------------------------------

def _term(rank, shape, seed=11):
    """Rank ``rank``'s term: a different draw a rank."""
    return _arr(shape, seed + rank, np.float32)


def collectives(rank, world, conf):
    """The four model-axis functions over a (world / m, m) mesh for each
    m of ``conf["ms"]``: forward values, backward gradients, and the
    bytes each sends over the model axis."""
    torch.set_num_threads(1)
    out = {}
    for m in conf["ms"]:
        mesh = mesh_of((world // m, m), world)
        ax = mesh.axis("model")
        r = ax.index
        shape = (3, 5, 2 * m)
        res = {}
        x = _term(r, shape).requires_grad_(True)
        g = _term(r, shape, 40)
        before = mesh.sent_by_axis["model"]
        y = C.reduce_from_model(x, ax)
        res["reduce_sent"] = mesh.sent_by_axis["model"] - before
        y.backward(g)
        res["reduce_y"], res["reduce_dx"] = y.detach().numpy(), \
            x.grad.numpy()
        x = _term(r, shape).requires_grad_(True)
        y = C.copy_to_model(x, ax)
        before = mesh.sent_by_axis["model"]
        y.backward(g)
        res["copy_sent"] = mesh.sent_by_axis["model"] - before
        res["copy_y"], res["copy_dx"] = y.detach().numpy(), x.grad.numpy()
        x = _term(r, shape).requires_grad_(True)
        y = C.gather_from_model(x, ax, 2)
        y.backward(_term(0, tuple(y.shape), 70))     # the same on every rank
        res["gather_y"], res["gather_dx"] = y.detach().numpy(), \
            x.grad.numpy()
        x = _term(0, shape).requires_grad_(True)     # the same on every rank
        y = C.slice_to_model(x, ax, 2)
        y.backward(_term(r, tuple(y.shape), 90))
        res["slice_y"], res["slice_dx"] = y.detach().numpy(), \
            x.grad.numpy()
        res["max"] = C.all_reduce(_term(r, (7,)), ax, op="max").numpy()
        res["coord"] = (mesh.axis("data").index, r)
        out[m] = res
    return out


REDUCE_LAYOUTS = {"4x1": ((4, 1), ("data", "model")),
                  "2x2": ((2, 2), ("data", "model")),
                  "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}


def reduce_leaves(rank, world, conf):
    """``reduce_leaf`` against ``psum_axes`` then the data cut, on every
    leaf of granite's and qwen2-0.5b's smoke models at each layout of
    ``REDUCE_LAYOUTS``: a gradient a rank, shaped as the step holds it
    (the model block, whole over the data axes), in f32 and bf16.
    Returns the names of the leaves whose bits differ, and how many
    bytes each reduce sent against the gather's."""
    torch.set_num_threads(1)
    out = {}
    for tag, (lay, names) in REDUCE_LAYOUTS.items():
        mesh = Mesh(lay, names, "cpu", group=dist.group.WORLD, ranks=lay)
        bad, sent_new, sent_old = [], 0, 0
        for arch in ("granite-moe-1b-a400m", "qwen2-0.5b"):
            cfg = smoke_config(get_config(arch))
            params = M.init_params(torch.Generator().manual_seed(0), cfg,
                                   max_seq=64, device="cpu")
            specs = S.param_specs(params, cfg, mesh)
            for i, (name, p) in enumerate(params.named_parameters()):
                blk = S.shard_leaf(p.data, specs[name], mesh,
                                   axes=("model",))
                for dt in (torch.float32, torch.bfloat16):
                    g = _term(mesh.rank, tuple(blk.shape), 1000 + i).to(dt)
                    s0 = mesh.sent_bytes
                    new = S.reduce_leaf(g, specs[name], mesh)
                    s1 = mesh.sent_bytes
                    old = S.shard_leaf(S.psum_axes(g, mesh), specs[name],
                                       mesh, axes=S.FSDP_AXES)
                    sent_new += s1 - s0
                    sent_old += mesh.sent_bytes - s1
                    if new.shape != old.shape or not torch.equal(
                            new.view(torch.int16 if dt == torch.bfloat16
                                     else torch.int32),
                            old.contiguous().view(
                                torch.int16 if dt == torch.bfloat16
                                else torch.int32)):
                        bad.append((arch, name, str(dt)))
        out[tag] = {"bad": bad, "sent_new": sent_new, "sent_old": sent_old}
    return out


def norms(rank, world, conf):
    """``adamw.global_norm`` of the blocks of a whole tree (the same on
    every rank: a draw a leaf) at (2, 2) and (1, 4): every model block
    and every leaf whole over ``model`` counted once."""
    from repro_torch.optim.adamw import global_norm
    torch.set_num_threads(1)
    out = {}
    for lay in ((2, 2), (1, 4)):
        mesh = mesh_of(lay, world)
        cfg = smoke_config(get_config(conf["arch"]))
        params = M.init_params(torch.Generator().manual_seed(0), cfg,
                               max_seq=64, device="cpu")
        specs = S.param_specs(params, cfg, mesh)
        blocks = {n: S.shard_leaf(_term(0, tuple(p.shape), 500 + i),
                                  specs[n], mesh)
                  for i, (n, p) in enumerate(params.named_parameters())}
        out[lay] = global_norm(blocks, mesh=mesh, specs=specs).numpy()
    return out


# --------------------------------------------------------------------------
# train steps, checkpoints and decodes over ranks
# --------------------------------------------------------------------------

def _no_model_gathers(calls):
    """A ``sharding.gather_leaf`` that records the axes of each call."""
    plain = S.gather_leaf

    def gather(block, spec, mesh, axes=None):
        calls.append(None if axes is None else tuple(axes))
        return plain(block, spec, mesh, axes=axes)
    return plain, gather


def train(rank, world, conf):
    """Each arch of ``conf["archs"]`` at each layout of ``conf["layouts"]``
    (2 steps of 2 microbatches, ``tests/torch_train_ranks_worker.py``'s
    data): losses, norms, the whole parameters gathered, each block's
    shape before and after the steps, the axes every parameter gather of
    the steps named, and the digests of each rank's blocks; with
    ``conf["ckpt"]`` = (dir, arch, layout) the state is saved there."""
    from repro_torch.ckpt.checkpoint import save
    torch.set_num_threads(1)
    out = {}
    for arch in conf["archs"]:
        for lay in conf["layouts"]:
            mesh = mesh_of(lay, world)
            cfg, params, specs, state = TW.placed(arch, mesh)
            before = {n: tuple(p.shape) for n, p in params.named_parameters()}
            calls = []
            plain, S.gather_leaf = _no_model_gathers(calls)
            try:
                params, state, res = TW.train_steps(arch, mesh, cfg, params,
                                                    specs, state)
            finally:
                S.gather_leaf = plain
            res["gather_axes"] = sorted(set(calls), key=str)
            res["n_gathers"] = len(calls)
            res["shapes_before"] = before
            res["shapes_after"] = {n: tuple(p.shape)
                                   for n, p in params.named_parameters()}
            res["blocks"] = {n: p.detach().numpy().copy()
                             for n, p in params.named_parameters()}
            res["coord"] = (mesh.axis("data").index,
                            mesh.axis("model").index)
            res["specs"] = specs
            res["params"], m, v = TW.gathered(params, state, specs, mesh)
            if conf.get("ckpt") and conf["ckpt"][1:] == (arch, lay):
                save(conf["ckpt"][0], TW.STEPS, (params, state), mesh=mesh,
                     specs=specs)
                res["m"], res["v"] = m, v
            out[(arch, lay)] = res
    return out


def remat_steps(rank, world, conf):
    """One step (2 microbatches) of each arch of ``conf["archs"]`` over a
    (2, 2) mesh under each remat policy, from the same placed state:
    the loss, the norm, the whole parameters gathered, every
    (axis, bytes) this rank sent in order, and the bytes the specs
    reckon over each axis apart from the model axis's activations."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "tools"))
    import chip_train_ranks as CT
    from repro_torch.data.pipeline import SyntheticLM, device_put_batch
    from repro_torch.optim.adamw import AdamWConfig
    torch.set_num_threads(1)
    out = {}
    for arch in conf["archs"]:
        for remat in ("none", "full", "dots"):
            mesh = mesh_of((2, 2), world)
            cfg, params, specs, state = TW.placed(arch, mesh)
            by_axis = CT.predicted_by_axis(params, specs, mesh, TW.MICRO)
            log = []
            plain = mesh.count_sent

            def count_sent(axis, n):
                log.append((axis.name, n))
                plain(axis, n)
            mesh.count_sent = count_sent
            step = TW.make_train_step(cfg, AdamWConfig(**TW.OPT),
                                      microbatches=TW.MICRO, remat=remat,
                                      mesh=mesh, specs=specs)
            data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TW.SEQ,
                               global_batch=TW.B)
            batch = device_put_batch(data.batch_at(0), mesh,
                                     microbatches=TW.MICRO)
            params, state, om = step(params, state, batch)
            mesh.count_sent = plain
            out[(arch, remat)] = {
                "loss": om["loss"].numpy(),
                "grad_norm": om["grad_norm"].numpy(),
                "params": TW.gathered(params, state, specs, mesh)[0],
                "sent": log, "by_axis": by_axis}
    return out


def restore_onto(rank, world, conf):
    """``conf["dir"]`` restored onto this group's ``conf["layout"]``;
    the whole leaves gathered back and the step."""
    from repro_torch.ckpt.checkpoint import restore
    torch.set_num_threads(1)
    mesh = mesh_of(conf["layout"], world)
    cfg, params, specs, state = TW.placed(conf["arch"], mesh)
    params, state = restore(conf["dir"], TW.STEPS, (params, state),
                            device="cpu", mesh=mesh, specs=specs)
    return TW.gathered(params, state, specs, mesh) + (int(state.step),)


def decode(rank, world, conf):
    """Each arch of ``conf["archs"]`` decoded over a (2, 2) mesh of 4
    ranks on its model blocks, each data rank its 2 rows of the prompt
    and of the reference's noise: the tokens gathered, the prompt's last
    logits and the first step's logits (this rank's vocabulary block),
    and the calls of ``gather_leaf`` the serve steps made."""
    from repro_torch.launch.serve import state_from_prefill
    from repro_torch.runtime.steps import make_serve_step
    torch.set_num_threads(1)
    mesh = mesh_of((2, 2), world)
    out = {}
    for arch in conf["archs"]:
        cfg, params = TW.init(arch)
        specs = place_blocks(params, cfg, mesh, axes=("model",))
        shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
        rows = S.shard_leaf(torch.arange(TW.DEC_B), ("data",), mesh)
        tokens = torch.from_numpy(conf["tokens"])[rows]
        noise = torch.from_numpy(conf["noise"][arch])[:, rows]
        with L.use_mesh(mesh):
            last, pstate = M.prefill(params, cfg, {"tokens": tokens})
            tok = M.argmax_vocab(last, cfg)[:, None].to(torch.int32)
        state = state_from_prefill(cfg, pstate, TW.DEC_PROMPT + TW.DEC_GEN)
        with L.use_mesh(mesh):
            first, _ = M.decode_step(params, cfg, state._replace(caches=[
                {k: (type(v)(*(t.clone() for t in v)) if hasattr(v, "_fields")
                     else v.clone()) for k, v in c.items()}
                for c in state.caches]), tok)
        step = make_serve_step(cfg, mesh, k=TW.DEC_K)
        calls = []
        plain, S.gather_leaf = _no_model_gathers(calls)
        try:
            toks = [tok]
            for i in range(TW.DEC_GEN - 1):
                tok, state = step(params, state, tok, None, noise=noise[i])
                toks.append(tok)
        finally:
            S.gather_leaf = plain
        toks = S.gather_leaf(torch.cat(toks, dim=1), ("data", None), mesh)
        out[arch] = {"tokens": toks.numpy(), "last": last.numpy(),
                     "first": first[:, 0].numpy(), "rows": rows.numpy(),
                     "coord": (mesh.axis("data").index,
                               mesh.axis("model").index),
                     "gathers": len(calls),
                     "shapes_kept": shapes == {
                         n: tuple(p.shape)
                         for n, p in params.named_parameters()}}
    return out


def family_model(arch):
    """(cfg, the smoke model from seed 0), both in f64, the router too:
    a family's step in f64, where AdamW's first, sign-like step does not
    turn the f32 rounding of a small gradient into a move of lr's
    size."""
    import dataclasses
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              param_dtype="float64",
                              compute_dtype="float64")
    return cfg, M.init_params(torch.Generator().manual_seed(0), cfg,
                              max_seq=TW.MAX_SEQ, device="cpu").double()


def family_step(rank, world, conf):
    """One train step of each arch of ``conf["archs"]`` (smoke, f64) over
    a (1, 2) mesh: the loss, the norm and the whole parameters."""
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    torch.set_num_threads(1)
    mesh = mesh_of((1, world), world)
    out = {}
    for arch in conf["archs"]:
        cfg, params = family_model(arch)
        specs = place_blocks(params, cfg, mesh)
        state = adamw_init(params, AdamWConfig(**TW.OPT))
        params, state, om = one_step(cfg, params, state, mesh, specs)
        out[arch] = (om["loss"].numpy(), om["grad_norm"].numpy(),
                     TW.gathered(params, state, specs, mesh)[0])
    return out


def one_step(cfg, params, state, mesh, specs=None):
    """One step of 2 microbatches on ``family_batch``'s rows."""
    from repro_torch.data.pipeline import device_put_batch
    from repro_torch.optim.adamw import AdamWConfig
    step = TW.make_train_step(cfg, AdamWConfig(**TW.OPT),
                              microbatches=TW.MICRO, remat="none",
                              mesh=mesh, specs=specs)
    raw = family_batch(cfg)
    batch = (device_put_batch(raw, mesh, microbatches=TW.MICRO)
             if mesh.multi_rank else device_put_batch(raw, "cpu"))
    return step(params, state, batch)


def family_batch(cfg):
    """A batch of SyntheticLM's rows with the modality stubs' inputs."""
    from repro_torch.data.pipeline import SyntheticLM, extra_model_inputs
    raw = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TW.SEQ,
                      global_batch=TW.B, seed=9).batch_at(0)
    return extra_model_inputs(cfg, raw)



def many(rank, world, jobs):
    """Several of this module's functions on one group: ``jobs`` is
    ``{key: (function name, conf)}``; returns ``{key: its result}``."""
    return {key: globals()[fn](rank, world, conf)
            for key, (fn, conf) in jobs.items()}
