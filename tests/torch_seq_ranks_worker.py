"""What each gloo rank of ``tests/test_torch_seq_ranks.py`` runs.

A module of its own (torch, numpy and the port only, no JAX): the
ranks are spawned processes that import their functions by name.  The
inputs are made from numpy seeds, so the test process makes the same
ones for the one-process port.  Every function returns numpy outputs.
"""
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core.mesh import Mesh, all_to_all, max_over_model
from repro_torch.data.pipeline import extra_model_inputs
from repro_torch.launch.serve import state_from_prefill
from repro_torch.launch.train import place_blocks
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import sharding as S
from repro_torch.runtime.steps import make_serve_step

#: rows of every decode
B = 2
#: the f64 cases: name -> (arch, changes to its smoke config, the model
#: axis's size (None: one peer a model rank), prompt, teacher-forced
#: steps, s_max).  With S_max 16 the full caches' blocks are 8 (2
#: ranks) or 4 (4 ranks) positions: positions 3 to 8 hold the first
#: block's last slot and the next block's first, while later blocks are
#: wholly masked.  recurrentgemma-2b at 3 layers has one attention layer,
#: stacked in the reference's scan group (reference fault 10's
#: ``pos_slots``); its ring of 32 slots is partly empty after a 3-token
#: prompt and wraps after a 30-token one.  A model axis of 8 peers keeps
#: the smoke config's 4 heads whole on every rank.  granite-moe's
#: experts split over the model ranks (expert-parallel), its 4 query
#: heads too, its 2 KV heads at 2 ranks and not at 4.  With 12 query
#: heads over 3 KV heads, the ranks' KV heads overlap and differ in
#: number (1, 2, 2, 1 at 4 ranks).
CASES = {
    "gqa_split_heads": ("qwen2-0.5b", {}, None, 3, 6, 16),
    "gqa_whole_heads": ("qwen2-0.5b", {}, 8, 3, 6, 16),
    "gqa_uneven_heads": ("qwen2-0.5b", {"n_heads": 12, "n_kv_heads": 3},
                         None, 3, 6, 16),
    "mla": ("minicpm3-4b", {}, None, 3, 6, 16),
    "cross": ("whisper-large-v3", {}, None, 3, 6, 16),
    "window_fill": ("recurrentgemma-2b", {"n_layers": 3}, None, 3, 6, 36),
    "window_wrap": ("recurrentgemma-2b", {"n_layers": 3}, None, 30, 5, 36),
    "moe": ("granite-moe-1b-a400m", {}, None, 3, 6, 16),
}
#: the cases whose one-process reference decodes each data rank's rows
#: alone: MoE takes its capacity from a data shard's own tokens, so a
#: row depends on its batch-mates (reference fault 8)
PER_DATA_BLOCK = ("moe",)
LAYOUTS = ((1, 2), (1, 4), (2, 2))
#: the decode held to the reference: its archs (with their changes),
#: prompt, tokens and k; S_max 36 divides 2 and 4, and the window's 32
#: slots wrap over the 36 positions
REF_ARCHS = {"qwen2-0.5b": {}, "recurrentgemma-2b": {"n_layers": 3}}
REF_PROMPT, REF_GEN, REF_K = 30, 6, 5
MAX_SEQ = 64


def model(arch, changes, dtype="float64"):
    """(cfg, the smoke model from seed 0 on the CPU) in ``dtype``."""
    cfg = dataclasses.replace(smoke_config(get_config(arch)), **changes)
    if dtype == "float64":
        cfg = dataclasses.replace(cfg, param_dtype=dtype,
                                  compute_dtype=dtype)
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           max_seq=MAX_SEQ, device="cpu")
    return cfg, params.double() if dtype == "float64" else params


def case_inputs(name):
    """The case's whole batch: tokens (B, prompt + steps) int32 and an
    encoder-decoder's frames."""
    arch, changes, _, prompt, steps, _ = CASES[name]
    cfg = dataclasses.replace(smoke_config(get_config(arch)), **changes)
    toks = np.random.default_rng(30).integers(
        0, cfg.vocab_size, (B, prompt + steps)).astype(np.int32)
    return extra_model_inputs(cfg, {"tokens": toks})


def leaves(state):
    """Every tensor of a decode state's caches, by "layer/key/field",
    copied (decode writes the caches in place)."""
    out = {}
    for i, layer in enumerate(state.caches):
        for key, c in layer.items():
            fields = c._asdict().items() if hasattr(c, "_fields") \
                else [("", c)]
            for f, t in fields:
                out[f"{i}/{key}/{f}".rstrip("/")] = t.clone().numpy()
    return out


def decode_case(name, mesh=None, rows=None):
    """The case's prefill and teacher-forced decode steps on this rank's
    rows and model blocks (without ``mesh`` the whole model and batch,
    or the batch's ``rows``), in f64: the prompt's last logits, each
    step's logits (this rank's vocabulary block), the caches' leaves
    after the prefill's conversion and after each step, the bytes each
    step delivers by axis, the keys of the caches cut over the model
    ranks."""
    arch, changes, _, prompt, steps, s_max = CASES[name]
    cfg, params = model(arch, changes)
    rows = np.arange(B) if rows is None else np.asarray(rows)
    if mesh is not None:
        place_blocks(params, cfg, mesh, axes=("model",))
        rows = S.shard_leaf(torch.arange(B), ("data",), mesh).numpy()
    whole = case_inputs(name)
    toks = torch.from_numpy(whole["tokens"][rows])
    batch = {"tokens": toks[:, :prompt]}
    if "frames" in whole:
        batch["frames"] = torch.from_numpy(whole["frames"][rows])
    with L.use_mesh(mesh):
        last, pstate = M.prefill(params, cfg, batch)
        state = state_from_prefill(cfg, pstate, s_max,
                                   cache_dtype=torch.float64)
        out = {"last": last.numpy(), "caches": [leaves(state)],
               "split": dict(state.seq_split), "logits": [], "sent": [],
               "rows": rows}
        for i in range(steps):
            before = dict(mesh.sent_by_axis) if mesh is not None else {}
            logits, state = M.decode_step(params, cfg, state,
                                          toks[:, prompt + i:prompt + i + 1])
            out["logits"].append(logits[:, 0].numpy())
            out["caches"].append(leaves(state))
            out["sent"].append({a: mesh.sent_by_axis[a] - before[a]
                                for a in before})
    if mesh is not None:
        out["coord"] = (mesh.axis("data").index, mesh.axis("model").index)
    return out


def ref_inputs(arch):
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              **REF_ARCHS[arch])
    return np.random.default_rng(31).integers(
        0, cfg.vocab_size, (B, REF_PROMPT)).astype(np.int32)


def ref_decode(arch, mesh, noise):
    """``serve decode``'s path for the reference's comparison on this
    rank's model blocks (smoke config, f32): prefill, the state laid
    out over the model ranks, ``REF_GEN - 1`` serve steps on the
    reference's noise; the tokens gathered, the prompt's last logits,
    the first step's logits (this rank's vocabulary block), the state's
    leaves and cut keys."""
    cfg, params = model(arch, REF_ARCHS[arch], dtype=None)
    place_blocks(params, cfg, mesh, axes=("model",))
    rows = S.shard_leaf(torch.arange(B), ("data",), mesh)
    tokens = torch.from_numpy(ref_inputs(arch))[rows]
    noise = torch.from_numpy(noise)[:, rows]
    s_max = REF_PROMPT + REF_GEN
    with L.use_mesh(mesh):
        last, pstate = M.prefill(params, cfg, {"tokens": tokens})
        state = state_from_prefill(cfg, pstate, s_max)
        layout = {k: v.shape for k, v in leaves(state).items()}
        tok = M.argmax_vocab(last, cfg)[:, None].to(torch.int32)
        first, _ = M.decode_step(params, cfg, state._replace(caches=[
            {k: (type(v)(*(t.clone() for t in v)) if hasattr(v, "_fields")
                 else v.clone()) for k, v in c.items()}
            for c in state.caches]), tok)
    step = make_serve_step(cfg, mesh, k=REF_K)
    toks = [tok]
    for i in range(REF_GEN - 1):
        tok, state = step(params, state, tok, None, noise=noise[i])
        toks.append(tok)
    toks = S.gather_leaf(torch.cat(toks, dim=1), ("data", None), mesh)
    return {"tokens": toks.numpy(), "last": last.numpy(),
            "first": first[:, 0].numpy(), "rows": rows.numpy(),
            "layout": layout, "split": dict(state.seq_split),
            "coord": (mesh.axis("data").index, mesh.axis("model").index)}


def term(rank, shape=(3, 8, 5)):
    """A rank's f64 term for the collectives."""
    return np.random.default_rng(100 + rank).standard_normal(shape)


def collectives(mesh, rank):
    """``max_over_model`` and ``all_to_all`` (dim 1 cut, the blocks
    joined on dim 2) of this rank's term over the model ranks, and the
    bytes each sent."""
    ax = mesh.axis("model")
    x = torch.from_numpy(term(rank))
    out = {}
    for name, fn in (("max", lambda: max_over_model(x, ax)),
                     ("a2a", lambda: all_to_all(x, ax, 1, 2))):
        before = mesh.sent_by_axis["model"]
        out[name] = fn().numpy()
        out[f"{name}_sent"] = mesh.sent_by_axis["model"] - before
    return out


def _noise(path, timeout=300.0):
    """The reference's noise, once its subprocess has written it."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no reference noise at {path}")
        time.sleep(0.05)
    return np.load(path)


def run(rank, world, conf):
    """Every case at (1, 2) (the two pairs of ranks, each its share of
    the cases, at once), (1, 4) and (2, 2), the collectives at (1, 4),
    then the reference's decodes at (1, 4) on its noise (the file
    ``conf["noise"]``)."""
    torch.set_num_threads(1)
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    meshes = {}

    def mesh_of(lay, msize):
        key = (lay, msize)
        if key not in meshes:
            group = (pairs[rank // 2] if lay == (1, 2)
                     else dist.group.WORLD)
            meshes[key] = Mesh((lay[0], msize or lay[1]), ("data", "model"),
                               "cpu", group=group, ranks=lay)
        return meshes[key]

    out = {}
    names = sorted(CASES)
    for lay in LAYOUTS:
        for i, name in enumerate(names):
            if lay == (1, 2) and i % 2 != rank // 2:
                continue
            out[(name, lay)] = decode_case(name, mesh_of(lay, CASES[name][2]))
    out["collectives"] = collectives(mesh_of((1, 4), None), rank)
    noise = _noise(conf["noise"])
    for arch in REF_ARCHS:
        out[("reference", arch)] = ref_decode(arch, mesh_of((1, 4), None),
                                              noise)
    return out
