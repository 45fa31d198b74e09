"""What tests/test_torch_dryrun.py runs away from its own process.

* :func:`cells` (``python tests/torch_dryrun_worker.py cells OUT``): the
  dry run's fake worlds, each made and torn down by
  ``launch/dryrun.py`` in this one process; writes JSON to ``OUT``.
* :func:`reference` (``... reference OUT``): the reference's
  ``pick_microbatches`` / ``input_specs`` for every arch x shape x mesh
  and its ``hlo_parse.analyze`` FLOPs of tiny prefills.  Importing the
  reference's ``launch/dryrun.py`` sets ``XLA_FLAGS``, so it runs here.
* :func:`mesh_repairs`: what each of 4 gloo ranks runs to show the mesh
  builds and exchanges as before over a real backend.
"""
import json
import sys

#: (arch, batch, seq, q_block) of the tiny dense prefills held to the
#: reference's HLO FLOPs
TINY_PREFILLS = [("qwen2-0.5b", 2, 64, 1024), ("qwen2-0.5b", 2, 128, 32),
                 ("qwen1.5-0.5b", 1, 96, 32)]
#: the small training cell held to chip_train_ranks.predicted_bytes
SMALL_TRAIN = ("granite-moe-1b-a400m", 32, 64, 2)   # arch, batch, seq, mb
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def cells(out_path: str) -> None:
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    sys.path.insert(0, "tools")
    import chip_train_ranks
    from repro_torch.configs.base import (ShapeConfig, get_config,
                                          smoke_config)
    from repro_torch.core.mesh import _synchronize
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.train import place_blocks

    out = {"decode": {}, "prefill": {}}
    for mp in (False, True):
        rec = D.run_cell("qwen1.5-0.5b", "decode_32k", multi_pod=mp,
                         verbose=False)
        out["decode"][rec["mesh"]] = rec
    out["phi3_long"] = D.run_cell("phi3-medium-14b", "long_500k",
                                  verbose=False)
    out["rwkv_long"] = D.run_cell("rwkv6-3b", "long_500k", verbose=False)

    arch, batch, seq, mb = SMALL_TRAIN
    cfg = smoke_config(get_config(arch))
    shape = ShapeConfig("train_small", seq, batch, "train")
    rec = D.trace_cell(cfg, shape, overrides={"microbatches": mb})
    device = D.trace_device("train")
    with D._fake_world(256) as group, FakeTensorMode():
        mesh = make_production_mesh(group=group, device=device)
        params = D._init_params(cfg, 4096, device)
        specs = place_blocks(params, cfg, mesh)
        predicted = chip_train_ranks.predicted_bytes(
            params, specs, mesh, microbatches=mb, cfg=cfg,
            rows=batch // mesh.axis("data").ranks, seq=seq, remat="full")
        model = mesh.axis("model")
        out["production"] = {"ranks": dict(mesh.ranks),
                             "backend": dist.get_backend(model.group),
                             "peers": list(model.peers)}
        _synchronize(torch.zeros(2, device=torch.device("cuda", 0)))
    out["train"] = {"record": rec, "predicted": predicted}

    for arch, b, s, qb in TINY_PREFILLS:
        cfg = smoke_config(get_config(arch))
        r = D.trace_cell(cfg, ShapeConfig("p", s, b, "prefill"),
                         mesh_shape=(1, 1),
                         overrides={"q_block": qb, "kv_block": qb})
        out["prefill"][f"{arch}/{b}/{s}/{qb}"] = r["flops"]
    with open(out_path, "w") as f:
        json.dump(out, f)


def reference(out_path: str) -> None:
    import types

    import jax
    import jax.numpy as jnp
    from repro.configs.base import (SHAPES, get_config, list_archs,
                                    shape_applicable, smoke_config)
    from repro.launch import dryrun as RD
    from repro.models import model as M
    from repro.roofline.hlo_parse import analyze
    from repro.runtime.steps import make_prefill_step

    out = {"cells": {}, "prefill": {}}
    for arch in list_archs():
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            for mesh_name, mesh_shape in MESHES.items():
                mesh = types.SimpleNamespace(shape=mesh_shape)
                specs = RD.input_specs(cfg, shape)
                out["cells"][f"{arch}/{name}/{mesh_name}"] = {
                    "microbatches": RD.pick_microbatches(cfg, shape, mesh),
                    "inputs": {k: [list(v.shape), str(v.dtype)]
                               for k, v in specs.items()},
                    "applicable": shape_applicable(cfg, shape)}
    out["skip"] = RD.run_cell("phi3-medium-14b", "long_500k",
                              verbose=False)
    for arch, b, s, qb in TINY_PREFILLS:
        cfg = smoke_config(get_config(arch))
        params = jax.eval_shape(
            lambda k: M.init_params(k, cfg, max_seq=4096),
            jax.ShapeDtypeStruct((2,), jnp.uint32))
        batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
        step = make_prefill_step(cfg, q_block=qb, kv_block=qb)
        text = jax.jit(step).lower(params, batch).compile().as_text()
        out["prefill"][f"{arch}/{b}/{s}/{qb}"] = analyze(text).flops
    with open(out_path, "w") as f:
        json.dump(out, f)


def mesh_repairs(rank: int, world: int) -> dict:
    """A (2, 4) data x model mesh over 4 gloo ranks laid out (2, 2):
    its subgroups' backend, one round of each exchange on integer data,
    the bytes sent, and the production mesh's layout over the group."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import mesh as M
    from repro_torch.launch.mesh import make_production_mesh

    group = dist.group.WORLD
    mesh = M.Mesh((2, 4), ("data", "model"), "cpu", group=group,
                  ranks=(2, 2))
    data, model = mesh.axis("data"), mesh.axis("model")
    # peer p of the model axis holds rows p * 10 + [0, 1, 2]
    x = torch.stack([torch.arange(3, dtype=torch.float32) + 10 * p
                     for p in range(model.offset,
                                    model.offset + model.local)])
    perm = M.permutation([(p, (p + 1) % 4) for p in range(4)], 4, "cpu",
                         model)
    (rolled,) = M.ppermute_all([x], perm, model)
    gathered = M.all_gather(x, model)
    summed = M.psum(x, -2, model)
    (bcast,) = M.broadcast_all([x + 100 * data.index], data)
    prod = make_production_mesh(device="cpu", group=group)
    return {"backends": [dist.get_backend(data.group),
                         dist.get_backend(model.group)],
            "rolled": rolled.tolist(), "gathered": gathered.tolist(),
            "summed": summed.tolist(), "bcast": bcast.tolist(),
            "sent": mesh.sent_bytes, "coord": (data.index, model.index),
            "production": dict(prod.ranks)}


if __name__ == "__main__":
    {"cells": cells, "reference": reference}[sys.argv[1]](sys.argv[2])
