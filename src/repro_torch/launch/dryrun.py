"""Dry run: trace every (arch x shape x mesh) as one rank of the
production mesh, on fake tensors over a fake world.

The port's counterpart of ``src/repro/launch/dryrun.py``, which lowers
and compiles each cell on 512 placeholder host devices and reads the
compiled module.  Here a cell impersonates rank 0 of the reference's
production mesh, one peer a rank: (16, 16) over ``("data", "model")``,
256 ranks, or (2, 16, 16) with ``"pod"`` first, 512 ranks.  The rank
lives in a process group of ``torch.distributed``'s ``fake`` backend
(every collective returns at once and moves nothing) and holds fake
tensors (``FakeTensorMode``: shapes, dtypes and a device, no storage)
on ``cuda``.  It builds the full-size model and this rank's state, then
runs the port's real step over the port's real ``Mesh``; nothing is
allocated and no card is touched, so a cell runs on a machine with or
without one.  ``roofline/trace.py`` counts what the step does: FLOPs,
bytes, collectives by op, calls of each kernel op and the peak of the
device's live bytes; ``roofline/analysis.py`` states the roofline
against an H100 from its data sheet.

Each cell's step is the port's, and so is what it reports:

* ``train``: ``make_train_step(mesh=, specs=)`` on this rank's blocks
  of the parameters and moments (``launch.train.place_blocks``), AdamW,
  ``remat="full"``, the reference's microbatches
  (:func:`pick_microbatches`): every leaf is gathered over the data
  axes only, so a leaf the specs put over ``model`` stays this rank's
  model block; the products run on the blocks, the model ranks
  exchanging activations (``core/mesh.py``'s model-axis collectives);
  every gradient is reduce-scattered over the data ranks;
* ``prefill``: ``make_prefill_step`` on this data rank's rows with this
  rank's model blocks of the weights, as ``serve decode --ranks``
  prefills;
* ``decode``: ``make_serve_step(cfg, mesh, k=20, algorithm="fd",
  schedule="halving")`` over the 16 model ranks, this rank's model
  blocks of the weights and its data rows of a decode state at its last
  position, laid out as ``serve decode --ranks`` lays it out
  (``optim/sharding.py::cache_seq_block``): each attention cache holds
  this rank's block of its sequence (S_max, the window, the encoder's
  frames) for every KV head where that dim divides the model size, else
  the KV heads the rank computes over the whole sequence; the Gumbel
  noise is an input.

Rows follow ``input_specs_pytree``'s fit: a batch the data ranks do not
divide (``long_500k``'s one row) is held whole by every rank.  Where
the port holds more than the reference's specs place on a rank, the
record shows both: ``memory`` is what the trace saw, and
``memory.specs_argument_gib`` what ``param_specs``, ``opt_state_specs``
and ``decode_state_specs`` would place; a decode cell's
``memory.cache_gib`` is the bytes of this rank's decode state and
``memory.specs_cache_gib`` those ``decode_state_specs`` places.

The reference's ``xla_cost_analysis`` and ``while_trip_counts`` have no
counterpart (nothing is compiled, eager runs every layer), and its
``convert_bytes_cpu_artifact`` is ``convert_bytes`` here: the bytes of
the dtype casts, which are real kernels on the card.  ``t_trace_s``
takes the place of ``t_lower_s`` and ``t_compile_s``.

A torch built without CUDA has no CUDA device guard, which fake CUDA
tensors need where they are indexed: ``roofline/fake_cuda.py`` gives it
a no-op one.  Its autograd engine still asks for CUDA streams, so there
a ``train`` cell traces on fake CPU tensors: the kernels' plain
versions run in place of the kernel ops, and the host buffers of the
exchanges count as device memory.  The record's ``device`` says which.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
  PYTHONPATH=src python -m repro_torch.roofline.report artifacts/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config, list_archs,
                                      shape_applicable)
from repro_torch.roofline.analysis import (HW, collective_terms,
                                           model_flops_estimate,
                                           roofline_terms)

DEFAULT_OUT = "artifacts/dryrun_torch"
ACT_BUDGET_BYTES = 4 * 2 ** 30      # boundary-activation budget per device
SKIP_REASON = ("long_500k needs sub-quadratic decode state "
               "(ssm/hybrid only) — DESIGN.md §5")


# --------------------------------------------------------------------------
# input specs (shape records — no allocation)
# --------------------------------------------------------------------------

class Spec(NamedTuple):
    """A tensor's shape and dtype, ``jax.ShapeDtypeStruct``'s stand-in."""
    shape: tuple
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract model inputs for a cell (tokens/labels + modality stubs)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        toks = Spec((b, 1), torch.int32)
        out = {"tokens": toks}
        return out
    out = {"tokens": Spec((b, s), torch.int32)}
    if shape.kind == "train":
        out["labels"] = Spec((b, s), torch.int32)
    if cfg.is_encoder_decoder:
        out["frames"] = Spec(
            (b, cfg.encoder_seq, cfg.d_model), torch.float32)
    if cfg.mrope_sections is not None:
        out["vision_embeds"] = Spec(
            (b, min(256, s), cfg.d_model), torch.float32)
    return out


def pick_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Smallest power-of-two microbatch count keeping per-device layer-
    boundary activations under ACT_BUDGET_BYTES (scan + full remat)."""
    mesh_shape = dict(mesh.shape)
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    per_dev = max(shape.global_batch // dp, 1)
    n_layers = cfg.n_layers + cfg.n_encoder_layers
    bnd = per_dev * shape.seq_len * cfg.d_model * 2 * n_layers
    m = 1
    while bnd // m > ACT_BUDGET_BYTES and m < per_dev:
        m *= 2
    return m


# --------------------------------------------------------------------------
# the fake world and this rank's state
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _fake_world(world: int):
    """A ``fake``-backend world of ``world`` ranks in which this process
    is rank 0 (None for one rank), torn down on exit."""
    if world == 1:
        yield None
        return
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a dry run makes its own fake world; this "
                           "process already has a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def trace_device(kind: str) -> torch.device:
    """Where a cell's fake tensors live: the card's, except a ``train``
    cell under a torch built without CUDA (see the module's note)."""
    if kind == "train" and not torch.backends.cuda.is_built():
        return torch.device("cpu")
    return torch.device("cuda", 0)


def _init_params(cfg: ModelConfig, max_seq: int, device: torch.device):
    """The full-size weights as fake tensors on ``device``: drawn on the
    CPU from a CPU generator (``init_params`` takes a generator of the
    weights' device, and no CUDA generator exists without a card), then
    each parameter replaced by its copy on ``device``."""
    from repro_torch.models import model as M
    params = M.init_params(torch.Generator("cpu").manual_seed(0), cfg,
                           max_seq=max_seq, device="cpu")
    if device.type != "cpu":
        for mod in params.modules():
            for name, p in list(mod._parameters.items()):
                if p is not None:
                    mod._parameters[name] = torch.nn.Parameter(
                        p.detach().to(device), requires_grad=p.requires_grad)
    return params


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block_shape(shape, spec, cut) -> tuple:
    """``shape`` with each dim divided by ``cut(axis)`` over the axes of
    its entry in ``spec``."""
    out = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        out.append(size // math.prod(cut(a) for a in _names(entry)))
    return tuple(out)


def _inputs(cfg, shape, mesh, device) -> dict:
    """This rank's rows of the cell's inputs: the batch dim cut over
    the data ranks where ``input_specs_pytree`` shards it."""
    from repro_torch.optim.sharding import input_specs_pytree
    specs = input_specs(cfg, shape)
    fit = input_specs_pytree({k: v.shape for k, v in specs.items()}, mesh)
    return {k: torch.zeros(
        _block_shape(v.shape, fit[k], lambda a: mesh.axis(a).ranks),
        dtype=v.dtype, device=device) for k, v in specs.items()}


def _pairs(state, specs) -> list:
    """(tensor, spec) of each leaf of a decode state's caches."""
    if torch.is_tensor(state):
        return [(state, specs)]
    if isinstance(state, dict):
        return [x for k in state for x in _pairs(state[k], specs[k])]
    return [x for a, b in zip(state, specs) for x in _pairs(a, b)]


def _specs_cache_bytes(cfg, shape, mesh_shape: dict) -> int:
    """The bytes of the global batch's decode state that
    ``decode_state_specs`` places on one device of ``mesh_shape``."""
    from repro_torch.models import model as M
    from repro_torch.optim import sharding as S
    state = M.init_decode_state(cfg, batch=shape.global_batch,
                                s_max=shape.seq_len, device="meta")
    sspecs = S.decode_state_specs(state, cfg, mesh_shape,
                                  s_max=shape.seq_len)
    return sum(t.element_size() * math.prod(_block_shape(
        t.shape, sp, lambda a: mesh_shape.get(a, 1)))
        for t, sp in _pairs(state.caches, sspecs.caches))


def _specs_argument_bytes(cfg, shape, whole: dict, mesh_shape: dict) -> int:
    """What the reference's specs place on one device of ``mesh_shape``:
    the parameters of ``whole`` (``{name: (shape, itemsize)}``) by
    ``param_specs``, for training two f32 moments by
    ``opt_state_specs``, for decoding the caches of the global batch by
    ``decode_state_specs``, and the inputs by ``input_specs_pytree``."""
    from repro_torch.models import model as M
    from repro_torch.optim import sharding as S

    def block(shp, itemsize, spec):
        return itemsize * math.prod(_block_shape(
            shp, spec, lambda a: mesh_shape.get(a, 1)))

    shapes = {n: s for n, (s, _) in whole.items()}
    pspecs = S.param_specs(shapes, cfg, mesh_shape)
    total = sum(block(s, b, pspecs[n]) for n, (s, b) in whole.items())
    if shape.kind == "train":
        ospecs = S.opt_state_specs(shapes, cfg, mesh_shape)
        total += 2 * sum(block(s, 4, ospecs[n]) for n, s in shapes.items())
    if shape.kind == "decode":
        total += _specs_cache_bytes(cfg, shape, mesh_shape)
    specs = input_specs(cfg, shape)
    fit = S.input_specs_pytree({k: v.shape for k, v in specs.items()},
                               mesh_shape)
    total += sum(block(v.shape, torch.empty((), dtype=v.dtype)
                       .element_size(), fit[k]) for k, v in specs.items())
    return total


# --------------------------------------------------------------------------
# one cell
# --------------------------------------------------------------------------

def _mesh_name(mesh_shape) -> str:
    return "x".join(str(n) for n in mesh_shape)


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, *,
               mesh_shape: tuple = (16, 16), hw: HW = HW(),
               overrides: Optional[dict] = None) -> dict:
    """The record of ``cfg`` x ``shape`` traced as rank 0 of a fake
    world of ``prod(mesh_shape)`` ranks holding one peer each of the
    production mesh (``make_production_mesh``), (16, 16) or (2, 16,
    16); ``(1, 1)`` is one process on one device, no world.
    ``overrides``: ``microbatches``, ``remat``, ``q_block``,
    ``kv_block``, ``k``, ``algorithm``, ``schedule``, ``chunk_size`` as
    the reference's.  The fake tensors' device is
    :func:`trace_device`'s."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.mesh import Mesh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.train import place_blocks
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.roofline.trace import analyze
    from repro_torch.runtime.steps import (make_prefill_step,
                                           make_serve_step, make_train_step)

    overrides = overrides or {}
    if "chunk_size" in overrides and cfg.recurrent is not None:
        cfg = dataclasses.replace(cfg, recurrent=dataclasses.replace(
            cfg.recurrent, chunk_size=overrides["chunk_size"]))
    mesh_shape = tuple(mesh_shape)
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    world = math.prod(mesh_shape)
    device = trace_device(shape.kind)
    if device.type == "cuda":
        from repro_torch.roofline.fake_cuda import ensure_guard
        ensure_guard()
    record = {"arch": cfg.name, "shape": shape.name,
              "mesh": _mesh_name(mesh_shape), "kind": shape.kind,
              "skipped": False, "device": device.type, "rank": 0,
              "world": world}
    t0 = time.time()
    with _fake_world(world) as group, FakeTensorMode():
        if group is None:
            mesh = Mesh(mesh_shape, axes, device)
        else:
            mesh = make_production_mesh(multi_pod=len(mesh_shape) == 3,
                                        group=group, device=device)
            if tuple(mesh.shape.values()) != mesh_shape:
                raise ValueError(f"no production mesh of {mesh_shape}")
        params = _init_params(cfg, max(shape.seq_len, 4096), device)
        whole = {n: (tuple(p.shape), p.element_size())
                 for n, p in params.named_parameters()}
        if shape.kind != "train" and mesh.multi_rank:
            # the model blocks, as serve decode --ranks holds them
            place_blocks(params, cfg, mesh, axes=("model",))
        batch = _inputs(cfg, shape, mesh, device)
        q_block = overrides.get("q_block", 1024)
        kv_block = overrides.get("kv_block", 1024)
        if shape.kind == "train":
            microbatches = overrides.get(
                "microbatches", pick_microbatches(cfg, shape, mesh))
            record["microbatches"] = microbatches
            opt_cfg = AdamWConfig()
            specs = (place_blocks(params, cfg, mesh) if mesh.multi_rank
                     else None)
            opt = adamw_init(params, opt_cfg)
            step = make_train_step(
                cfg, opt_cfg, microbatches=microbatches,
                remat=overrides.get("remat", "full"), q_block=q_block,
                kv_block=kv_block, mesh=mesh, specs=specs)
            args = (params, opt, batch)
        elif shape.kind == "prefill":
            prefill = make_prefill_step(cfg, q_block=q_block,
                                        kv_block=kv_block)

            def step(params, batch):
                with L.use_mesh(mesh):
                    return prefill(params, batch)
            args = (params, batch)
        else:
            k = overrides.get("k", 20)
            with L.use_mesh(mesh):       # the caches laid out over ranks
                state = M.init_decode_state(
                    cfg, batch=batch["tokens"].shape[0],
                    s_max=shape.seq_len,
                    device=device)._replace(pos=shape.seq_len - 1)
            serve = make_serve_step(
                cfg, mesh, k=k, algorithm=overrides.get("algorithm", "fd"),
                schedule=overrides.get("schedule", "halving"))
            noise = torch.zeros((batch["tokens"].shape[0], k),
                                dtype=torch.float32, device=device)

            def step(params, state, tokens, noise):
                return serve(params, state, tokens, None, noise)
            args = (params, state, batch["tokens"], noise)
            cache_b = sum(t.numel() * t.element_size()
                          for t, _ in _pairs(state.caches, state.caches))
        mesh.sent_bytes = 0
        mesh.sent_by_axis = {a: 0 for a in mesh.axis_names}
        totals = analyze(step, *args, device=device.type)
    record["t_trace_s"] = round(time.time() - t0, 1)
    args_b = totals.argument_bytes
    temp_b = totals.peak_device_bytes - args_b
    total_b = totals.peak_device_bytes
    record["memory"] = {
        "argument_size_in_bytes": args_b,
        "temp_size_in_bytes": temp_b,
        "host_staging_bytes": totals.host_staging_bytes,
        "per_device_total_gib": round(total_b / 2 ** 30, 3),
        "fits": total_b <= hw.hbm_bytes,
        "specs_argument_gib": round(_specs_argument_bytes(
            cfg, shape, whole, dict(zip(axes, mesh_shape))) / 2 ** 30, 3)}
    if shape.kind == "decode":
        record["memory"]["cache_gib"] = round(cache_b / 2 ** 30, 3)
        record["memory"]["specs_cache_gib"] = round(_specs_cache_bytes(
            cfg, shape, dict(zip(axes, mesh_shape))) / 2 ** 30, 3)
    record["flops"] = totals.flops
    record["hlo_bytes"] = totals.bytes_accessed
    record["convert_bytes"] = totals.convert_bytes
    record["collective"] = {"total": totals.collective_bytes,
                            "by_op": totals.coll_by_op,
                            "counts": totals.coll_counts,
                            "by_axis": totals.coll_by_axis,
                            "counts_by_axis": totals.coll_counts_by_axis}
    record["kernels"] = totals.kernels
    record["ops"] = totals.ops
    record["sent_bytes"] = mesh.sent_bytes
    record["sent_by_axis"] = dict(mesh.sent_by_axis)
    mf = model_flops_estimate(cfg, shape, mode=shape.kind)
    record["roofline"] = roofline_terms(
        hlo_flops=totals.flops, hlo_bytes=totals.bytes_accessed,
        collective_bytes=totals.collective_bytes, hw=hw, model_flops=mf,
        chips=world)
    record["roofline"]["by_axis"] = collective_terms(totals.coll_by_axis,
                                                     hw)
    record["roofline"]["note"] = ("H100 SXM data-sheet bounds of the "
                                  "counts, not measurements")
    return record


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             hw: HW = HW(), verbose: bool = True,
             overrides: Optional[dict] = None) -> dict:
    """The reference's ``run_cell`` on the port: ``arch`` x
    ``shape_name`` on the production mesh (2x16x16 with
    ``multi_pod``), or the reference's skip record."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": SKIP_REASON}
    record = trace_cell(cfg, shape,
                        mesh_shape=(2, 16, 16) if multi_pod else (16, 16),
                        hw=hw, overrides=overrides)
    if verbose:
        terms = record["roofline"]
        mem = record["memory"]
        print(f"[{record['mesh']}] {arch} × {shape_name}: "
              f"trace {record['t_trace_s']:.0f}s on {record['device']}  "
              f"mem/dev {mem['per_device_total_gib']} GiB "
              f"(fits {mem['fits']}, specs {mem['specs_argument_gib']})  "
              f"compute {terms['compute_s']:.3e}s "
              f"mem {terms['memory_s']:.3e}s "
              f"coll {terms['collective_s']:.3e}s → {terms['dominant']}  "
              f"roofline {terms.get('roofline_frac', 0):.1%}", flush=True)
    return record


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", dest="mp", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    cells = []
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.mp]
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
                path = os.path.join(args.out, tag + ".json")
                try:
                    rec = run_cell(arch, shape, multi_pod=mp)
                except Exception as e:                         # noqa: BLE001
                    failures += 1
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "error": str(e),
                           "traceback": traceback.format_exc()}
                    print(f"FAIL {tag}: {e}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                cells.append(rec)
    ok = sum(1 for c in cells if not c.get("error") and not c.get("skipped"))
    sk = sum(1 for c in cells if c.get("skipped"))
    print(f"\ndry-run: {ok} traced, {sk} skipped (structural), "
          f"{failures} failed, artifacts in {args.out}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
