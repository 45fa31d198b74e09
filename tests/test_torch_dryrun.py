"""The port's dry run (``launch/dryrun.py``) against the reference's, on
the CPU.

Two subprocesses run side by side, each under a time limit
(``tests/torch_dryrun_worker.py``): one makes the dry run's fake worlds
(256 and 512 ranks of the ``fake`` backend) one after another, the other
imports the reference's ``launch/dryrun.py`` (which sets ``XLA_FLAGS``)
and compiles the tiny prefills.  The mesh's repairs (the subgroups'
backend, the fake-tensor sync, the production mesh's one-peer-a-rank
layout) are held to a real backend by 4 gloo ranks.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import SHAPES, get_config, list_archs
from repro_torch.launch import dryrun as D
from repro_torch.launch.ranks import spawn_ranks

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dryrun_worker as W                               # noqa: E402

LIMIT_S = 300


def _start(what: str, out: Path, **env):
    return subprocess.Popen(
        [sys.executable, str(Path(W.__file__)), what, str(out)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                            **env))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = {"cells": _start("cells", tmp / "cells.json"),
             "reference": _start("reference", tmp / "reference.json",
                                 JAX_PLATFORMS="cpu")}
    out = {}
    try:
        for name, proc in procs.items():
            log, _ = proc.communicate(timeout=LIMIT_S)
            assert proc.returncode == 0, f"{name}:\n{log[-4000:]}"
            out[name] = json.loads((tmp / f"{name}.json").read_text())
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


@pytest.mark.parametrize("mesh_name", sorted(W.MESHES))
@pytest.mark.parametrize("shape_name", sorted(SHAPES))
def test_microbatches_and_inputs_are_the_references(runs, shape_name,
                                                    mesh_name):
    mesh = type("M", (), {"shape": W.MESHES[mesh_name]})
    for arch in list_archs():
        cfg, shape = get_config(arch), SHAPES[shape_name]
        ref = runs["reference"]["cells"][f"{arch}/{shape_name}/{mesh_name}"]
        assert D.pick_microbatches(cfg, shape, mesh) == ref["microbatches"]
        got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
               for k, v in D.input_specs(cfg, shape).items()}
        assert got == ref["inputs"], arch


def test_skip_rules_are_the_references(runs):
    cells = runs["reference"]["cells"]
    skipped = sorted(k for k, v in cells.items() if not v["applicable"])
    assert "phi3-medium-14b/long_500k/16x16" in skipped
    assert not any(k.startswith("rwkv6-3b/") for k in skipped)
    for key in skipped:
        arch, shape, mesh = key.split("/")
        rec = D.run_cell(arch, shape, multi_pod=mesh == "2x16x16",
                         verbose=False)
        assert rec == runs["reference"]["skip"] | {"arch": arch,
                                                    "shape": shape}
    assert runs["cells"]["phi3_long"] == runs["reference"]["skip"]
    rwkv = runs["cells"]["rwkv_long"]
    assert not rwkv["skipped"] and rwkv["flops"] > 0
    assert rwkv["kernels"] == {"topk": 1, "merge": 4}


@pytest.mark.parametrize("mesh_name", sorted(W.MESHES))
def test_full_size_decode_cell(runs, mesh_name):
    """qwen1.5-0.5b x decode_32k as rank 0 of 256 / 512 ranks: counts,
    the dominant term, and the kernel calls FD's halving implies: one
    local top-k of the vocabulary block and a merge a round, log2(16)
    rounds over the 16 model ranks, then one broadcast of the answer
    from the root (rank 0) to the other 15; beside it the model axis's
    sums of the products split over the 16 model ranks, their operands
    and bytes as ``tools/chip_train_ranks.py::model_axis_events``
    reckons them, and nothing over the data axes."""
    rec = runs["cells"]["decode"][mesh_name]
    rows = 128 // math.prod(n for a, n in W.MESHES[mesh_name].items()
                            if a != "model")
    assert rec["device"] == "cuda" and rec["world"] == math.prod(
        W.MESHES[mesh_name].values())
    assert rec["flops"] > 0 and rec["hlo_bytes"] > 0
    assert rec["kernels"] == {"topk": 1, "merge": int(math.log2(16))}
    k, entry = 20, 4 + 4                   # an f32 value, an int32 owner
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_train_ranks as CT
    acts = CT.model_axis_bytes(CT.model_axis_events(
        get_config("qwen1.5-0.5b"), "decode", rows, 32768, 16, 16), 16)
    fd_bytes = rows * k * entry
    assert rec["collective"]["by_axis"] == {"model": {
        "collective-permute": fd_bytes, **acts["operands"]}}
    assert rec["collective"]["total"] == fd_bytes + sum(
        acts["operands"].values())
    assert rec["collective"]["counts"]["collective-permute"] == 1
    assert rec["sent_bytes"] == 15 * fd_bytes + acts["sent"]
    assert rec["roofline"]["dominant"] == "memory_s"
    assert rec["roofline"]["chips"] == rec["world"]
    assert rec["memory"]["fits"] is True
    assert 0 < rec["memory"]["specs_argument_gib"] < \
        rec["memory"]["per_device_total_gib"]


def test_small_train_cell_sends_the_predicted_bytes(runs):
    """A smoke-config train cell (the dry run's full remat) on the
    256-rank world delivers exactly the bytes ``tools/chip_train_ranks.py::
    predicted_bytes`` counts from the specs and the config: every leaf
    gathered over the data axes, every gradient reduce-scattered, the
    model axis's sums of activations with the recompute's replays."""
    got = runs["cells"]["train"]
    rec = got["record"]
    assert rec["microbatches"] == W.SMALL_TRAIN[3]
    assert rec["sent_bytes"] == got["predicted"] > 0
    assert rec["collective"]["counts"]["all-gather"] > 0
    assert rec["device"] == D.trace_device("train").type


def test_production_mesh_one_peer_a_rank_over_a_fake_world(runs):
    prod = runs["cells"]["production"]
    assert prod == {"ranks": {"data": 16, "model": 16}, "backend": "fake",
                    "peers": list(range(16))}


@pytest.mark.parametrize("key", [f"{a}/{b}/{s}/{q}"
                                 for a, b, s, q in W.TINY_PREFILLS])
def test_tiny_prefill_flops_are_the_references_hlo_flops(runs, key):
    """A dense prefill on one device: the port's traced matmul FLOPs
    equal the dot FLOPs of the reference's compiled module.  Both
    compute every attention block and every position's logits, so the
    difference is 0 for every shape here."""
    assert runs["cells"]["prefill"][key] == runs["reference"]["prefill"][key]


def test_mesh_repairs_keep_a_gloo_mesh_as_it_was():
    """4 gloo ranks as (data 2, model 2) over a (2, 4) mesh: the
    subgroups keep the group's backend (gloo), and a ppermute, a gather,
    a psum and a broadcast give the one-process mesh's values with the
    bytes the rounds predict; the production mesh over 4 ranks keeps
    its outermost-axis layout."""
    outs = spawn_ranks(W.mesh_repairs, 4, timeout=240)
    whole = torch.arange(3, dtype=torch.float32) + 10 * torch.arange(
        4, dtype=torch.float32)[:, None]                      # (4 peers, 3)
    for out in outs:
        d, m = out["coord"]
        mine = slice(2 * m, 2 * m + 2)
        assert out["backends"] == ["gloo", "gloo"]
        assert out["rolled"] == whole.roll(1, 0)[mine].tolist()
        assert out["gathered"] == whole.reshape(-1).tolist()
        assert out["summed"] == whole.sum(0).tolist()
        assert out["bcast"] == whole[mine].tolist()
        # one 2-row message a round to the model partner, the gather's
        # 6 floats to it, the psum's gather of 6, the broadcast's 6 from
        # the data axis's first rank
        assert out["sent"] == 4 * (3 + 6 + 6 + (6 if d == 0 else 0))
        assert out["production"] == {"data": 4, "model": 1}


def test_trace_device_is_the_cards_but_training_without_cuda():
    card = torch.device("cuda", 0)
    assert D.trace_device("decode") == card
    assert D.trace_device("prefill") == card
    assert D.trace_device("train") == (
        card if torch.backends.cuda.is_built() else torch.device("cpu"))
