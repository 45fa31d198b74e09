"""The port's counter of a step (``roofline/trace.py``), calibrated as
``tests/test_sharding_and_hlo.py`` calibrates the reference's HLO
parser, and ``roofline/analysis.py`` / ``roofline/report.py`` held to
the reference's (pure Python: neither imports JAX).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import base as RB
from repro.roofline import analysis as RA
from repro.roofline import report as RR
from repro_torch.configs.base import SHAPES, get_config, list_archs
from repro_torch.kernels import _build
from repro_torch.kernels.merge import merge_scorelists
from repro_torch.kernels.topk import local_topk
from repro_torch.roofline import analysis as A
from repro_torch.roofline import report as R
from repro_torch.roofline.trace import COLL_OPS, analyze

ROOT = Path(__file__).resolve().parents[1]
CARD = torch.device("cuda", 0)


# --------------------------------------------------------------------------
# the counter
# --------------------------------------------------------------------------

def test_plain_matmul():
    m, n, k = 128, 64, 32
    x, w = torch.randn(m, k), torch.randn(k, n)
    t = analyze(lambda a, b: a @ b, x, w, device="cpu")
    assert t.flops == 2 * m * n * k
    assert t.bytes_accessed == 4 * (m * k + k * n + m * n)


def test_loop_of_six_matmuls():
    """What the reference reads from a scan's trip count, eager runs:
    six products count six times."""
    x, bs = torch.randn(64, 64), torch.randn(6, 64, 64)

    def loop(a, bs):
        for b in bs:
            a = a @ b
        return a
    assert analyze(loop, x, bs, device="cpu").flops == 6 * 2 * 64 ** 3


def test_elementwise_add_and_views():
    x, y = torch.randn(100, 30), torch.randn(100, 30)
    t = analyze(torch.add, x, y, device="cpu")
    assert t.bytes_accessed == 3 * x.numel() * x.element_size()
    assert t.flops == 0
    for view in (lambda a: a.view(3000), lambda a: a.t(),
                 lambda a: a[10:20], lambda a: a.unsqueeze(0)):
        assert analyze(view, x, device="cpu").bytes_accessed == 0


def test_converts_count_apart_and_inside_bytes():
    x = torch.randn(1000)
    t = analyze(lambda a: a.to(torch.bfloat16), x, device="cpu")
    assert t.convert_bytes == t.bytes_accessed == 1000 * (4 + 2)
    assert analyze(lambda a: a.to(torch.float32), x,
                   device="cpu").convert_bytes == 0


def test_peak_of_a_known_sequence_of_allocations():
    arg = torch.zeros(100)                                      # 400 B

    def allocs(_):
        a = torch.empty(1000)                                   # 4000
        b = torch.empty(2000)                                   # +8000
        del a                                                   # 8000
        c = torch.empty(1500)                                   # 14000
        d = c[:10]                             # a view: no new storage
        del b, c, d
    t = analyze(allocs, arg, device="cpu")
    assert t.argument_bytes == 400
    assert t.peak_device_bytes == 400 + 14000
    assert t.host_staging_bytes == 0


def test_peak_on_fake_card_tensors_and_host_staging():
    """Fake tensors hold no memory, yet their storages are counted by
    their sizes; host tensors a card trace makes count apart."""
    with FakeTensorMode():
        w = torch.empty(4096, 4096, dtype=torch.bfloat16, device=CARD)

        def step(w):
            y = w @ w                                           # 32 MiB
            h = torch.empty(1024, pin_memory=True)              # host
            del h
            return y.sum()
        t = analyze(step, w)
    size = 4096 * 4096 * 2
    assert t.argument_bytes == size
    assert t.peak_device_bytes == 2 * size + 2
    assert t.host_staging_bytes == 4096
    assert t.flops == 2 * 4096 ** 3


def test_fake_kernel_ops_count_as_kernels_and_launch_nothing():
    """The kernels' wrappers go through their ops on fake card tensors:
    one call a kernel, outputs of the right shapes and dtypes, no
    launch counted."""
    before = dict(_build.LAUNCHES)
    with FakeTensorMode():
        s = torch.empty(8, 4096, device=CARD)
        v = torch.empty(8, 20, device=CARD)
        i = torch.empty(8, 20, dtype=torch.int32, device=CARD)

        def step(s, v, i):
            vals, idx = local_topk(s, 20, index_offset=7)
            return vals, idx, merge_scorelists(v, i, vals, idx)
        t = analyze(step, s, v, i)
        vals, idx, (mv, mi) = step(s, v, i)
        direct = analyze(lambda s: torch.ops.repro_torch.topk(s, 5, 0), s)
    assert t.kernels == {"topk": 1, "merge": 1}
    assert direct.kernels == {"topk": 1}
    assert (vals.shape, vals.dtype, idx.dtype) == (
        (8, 20), torch.float32, torch.int32)
    assert (mv.shape, mv.dtype, mi.dtype) == (
        (8, 20), torch.float32, torch.int32)
    assert _build.LAUNCHES == before


def test_kernel_wrappers_still_refuse_other_devices():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no path for meta"):
        local_topk(x, 2)
    with pytest.raises(ValueError, match="no path for meta"):
        merge_scorelists(x, x.int(), x, x.int())
    with FakeTensorMode():
        bad = torch.empty(4, 8, device=CARD).t()
        with pytest.raises(ValueError, match="contiguous"):
            local_topk(bad, 2)


_COLLECTIVE = textwrap.dedent("""
    import json, torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.roofline.trace import analyze
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=16)
    x = torch.randn(4, 8)
    parts = [torch.empty_like(x) for _ in range(16)]
    t = analyze(lambda: dist.all_gather(parts, x), device="cpu")
    s = analyze(lambda: dist.broadcast(x, src=0), device="cpu")
    r = analyze(lambda: dist.broadcast(x, src=3), device="cpu")
    print(json.dumps([t.coll_counts, t.coll_by_op, t.collective_bytes,
                      s.coll_counts, r.collective_bytes]))
    dist.destroy_process_group()
""")


def test_one_all_gather_over_a_fake_group():
    out = subprocess.run([sys.executable, "-c", _COLLECTIVE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stdout + out.stderr
    import json
    counts, by_op, total, bcast, other = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert counts == {**{o: 0 for o in COLL_OPS}, "all-gather": 1}
    assert by_op["all-gather"] == total == 4 * 8 * 4
    assert bcast == {**{o: 0 for o in COLL_OPS}, "collective-permute": 1}
    assert other == 0                  # a rank that only receives sends 0


#: smoke train steps (2 microbatches) traced as rank 0 of a fake (data
#: 2, model 4) world: (arch, rows a data rank, seq, remat); without
#: remat, then under full and dots remat for each family whose
#: recompute replays a different share of its forward's sums
TP_STEPS = (("granite-moe-1b-a400m", 4, 32, "none"),
            ("qwen2-0.5b", 4, 32, "none"),
            ("whisper-large-v3", 4, 16, "none"),
            ("qwen2-vl-72b", 2, 300, "none"))
REMAT_STEPS = (("granite-moe-1b-a400m", 4, 32, "full"),
               ("qwen2-0.5b", 4, 32, "dots"),
               ("whisper-large-v3", 4, 16, "full"),
               ("rwkv6-3b", 4, 32, "full"),
               ("recurrentgemma-2b", 4, 32, "dots"),
               ("moonshot-v1-16b-a3b", 4, 32, "full"))
_TP_STEP = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    sys.path.insert(0, "tools")
    import chip_train_ranks as CT
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.data.pipeline import extra_model_inputs
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.train import place_blocks
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.roofline.trace import analyze
    from repro_torch.runtime.steps import make_train_step
    import numpy as np
    out = {}
    with D._fake_world(8) as group:
        mesh = Mesh((2, 4), ("data", "model"), "cpu", group=group,
                    ranks=(2, 4))
        for arch, rows, seq, remat in %r:
            cfg = smoke_config(get_config(arch))
            # at least one remat group (recurrentgemma's is 3 layers)
            cfg = dataclasses.replace(cfg, n_layers=max(
                cfg.n_layers, len(cfg.mixer_pattern)))
            params = M.init_params(torch.Generator().manual_seed(0), cfg,
                                   max_seq=512, device="cpu")
            specs = place_blocks(params, cfg, mesh)
            opt = adamw_init(params, AdamWConfig())
            step = make_train_step(cfg, AdamWConfig(), microbatches=2,
                                   remat=remat, mesh=mesh, specs=specs)
            raw = {"tokens": np.zeros((rows, seq), np.int32),
                   "labels": np.zeros((rows, seq), np.int32)}
            batch = {k: torch.from_numpy(v) for k, v in
                     extra_model_inputs(cfg, raw).items()}
            by_axis = CT.predicted_by_axis(params, specs, mesh, 2)
            mesh.sent_by_axis = {a: 0 for a in mesh.axis_names}
            t = analyze(step, params, opt, batch, device="cpu")
            acts = CT.model_axis_bytes(CT.model_axis_events(
                cfg, "train", rows, seq, 4, 4, microbatches=2,
                remat=remat), 4)
            plain = CT.model_axis_bytes(CT.model_axis_events(
                cfg, "train", rows, seq, 4, 4, microbatches=2), 4)
            out[f"{arch}/{remat}"] = [t.coll_by_axis,
                                      dict(mesh.sent_by_axis), by_axis,
                                      acts, plain["sent"]]
    print(json.dumps(out))
""") % (TP_STEPS + REMAT_STEPS,)


@pytest.fixture(scope="module")
def tp_steps():
    out = subprocess.run([sys.executable, "-c", _TP_STEP], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stdout + out.stderr
    import json
    return json.loads(out.stdout.strip().splitlines()[-1])


def _model_axis_bytes(got):
    coll, sent, by_axis, acts, _ = got
    want = dict(acts["operands"])
    want["all-gather"] += 4
    assert coll["model"] == want
    assert sent["model"] == by_axis["model"] + acts["sent"]
    assert sent["data"] == by_axis["data"] > 0
    assert set(coll) == {"data", "model"}


@pytest.mark.parametrize("arch", [a for a, _, _, _ in TP_STEPS])
def test_model_axis_bytes_of_a_smoke_train_step(tp_steps, arch):
    """A smoke train step over a fake (data 2, model 4) world: the
    trace's model-axis operands, by kind, are the reckoned sums of the
    products' activations (``tools/chip_train_ranks.py::
    model_axis_events``; an all-reduce is a reduce-scatter of the
    zero-padded tensor and an all-gather of its chunk) plus the
    gradient norm's all-gather of one f32; the bytes this rank delivers
    over each axis are the reckoned ones.  qwen2-0.5b's 14 heads do not
    divide the 4 model ranks: its attention runs whole, and only its
    FFN columns and vocabulary block split; qwen2-vl-72b's 300-token
    rows hold 256 vision slots, so the lookup's sum runs."""
    _model_axis_bytes(tp_steps[f"{arch}/none"])


@pytest.mark.parametrize("step", REMAT_STEPS,
                         ids=[f"{a}-{r}" for a, _, _, r in REMAT_STEPS])
def test_model_axis_bytes_under_remat(tp_steps, step):
    """The same under remat="full" / "dots": the backward's recompute of
    each remat group replays its forward's model-axis sums and gathers
    up to the last one a backward reads (``model_axis_events``' remat
    rule): granite's expert gather (the combine reads it), qwen2-0.5b's
    and whisper's attention sums but not their layers' closing FFN sum,
    RWKV's channel-mix sum (``r * v`` reads it), recurrentgemma's
    group of three layers (two RG-LRU, one attention), moonshot's shared
    experts."""
    arch, _, _, remat = step
    got = tp_steps[f"{arch}/{remat}"]
    _model_axis_bytes(got)
    assert got[3]["sent"] > got[4]          # the recompute replays sums


# --------------------------------------------------------------------------
# analysis.py and report.py against the reference
# --------------------------------------------------------------------------

def _ref_hw_as_port():
    ref = RA.HW()
    return A.HW(peak_flops=ref.peak_flops, hbm_bw=ref.hbm_bw,
                link_bw=ref.link_bw, dcn_bw=ref.dcn_bw)


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
def test_model_flops_and_roofline_terms_are_the_references(shape_name):
    for arch in list_archs():
        cfg, rcfg = get_config(arch), RB.get_config(arch)
        shape, rshape = SHAPES[shape_name], RB.SHAPES[shape_name]
        mf = A.model_flops_estimate(cfg, shape, mode=shape.kind)
        assert mf == RA.model_flops_estimate(rcfg, rshape, mode=shape.kind)
        for chips, flops, nbytes, coll in ((256, 3.5e14, 2.6e13, 9.9e8),
                                           (512, 1e12, 1e9, 0.0),
                                           (1, 0.0, 1.0, 5.0)):
            kw = dict(hlo_flops=flops, hlo_bytes=nbytes,
                      collective_bytes=coll, model_flops=mf, chips=chips)
            assert A.roofline_terms(hw=_ref_hw_as_port(), **kw) == \
                RA.roofline_terms(hw=RA.HW(), **kw)


def test_hw_is_the_h100_data_sheet():
    hw = A.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.dcn_bw,
            hw.hbm_bytes) == (989e12, 3.35e12, 450e9, 50e9, 80e9)
    for field, tpu in dataclasses.asdict(RA.HW()).items():
        assert getattr(hw, field) != tpu, field
    source = (ROOT / "src/repro_torch/roofline/analysis.py").read_text()
    for tpu in ("197e12", "819e9", "6.25e9"):
        assert tpu not in source


def _records():
    """Reference-shaped records of both meshes, with a skip and a
    failure."""
    recs = []
    for i, (arch, shape, mesh) in enumerate(
            [("qwen2-0.5b", "train_4k", "16x16"),
             ("qwen2-0.5b", "decode_32k", "2x16x16"),
             ("rwkv6-3b", "long_500k", "16x16")]):
        recs.append({
            "arch": arch, "shape": shape, "mesh": mesh, "kind": "train",
            "t_compile_s": 10.0 + i, "microbatches": 2,
            "memory": {"per_device_total_gib": 1.5 + i},
            "collective": {"total": 3e9 * (i + 1), "by_op": {
                "all-gather": 2e9, "all-reduce": 1e9 * i,
                "collective-permute": 0.0}},
            "roofline": RA.roofline_terms(
                hlo_flops=1e12 * (i + 1), hlo_bytes=5e11, hw=RA.HW(),
                collective_bytes=3e9, model_flops=2e14, chips=256)})
    recs.append({"arch": "phi3-medium-14b", "shape": "long_500k",
                 "mesh": "16x16", "skipped": True, "reason": "-"})
    recs.append({"arch": "x", "shape": "y", "mesh": "16x16",
                 "error": "boom"})
    return recs


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_report_tables_are_the_references(mesh):
    recs = _records()
    assert R.dryrun_table(recs, mesh) == RR.dryrun_table(recs, mesh)
    assert R.roofline_table(recs, mesh) == RR.roofline_table(recs, mesh)
    assert R.summary(recs) == RR.summary(recs)


def test_report_of_the_ports_records(tmp_path):
    recs = _records()
    for r in recs[:3]:
        r["t_trace_s"] = r.pop("t_compile_s")
        r.update(device="cuda", sent_bytes=2e9,
                 kernels={"topk": 1, "merge": 4})
        r["memory"].update(fits=True, specs_argument_gib=0.5)
    import json
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    loaded = R.load(str(tmp_path))
    table = R.dryrun_table(loaded, "16x16")
    assert "| trace(s) |" in table and "| 10.0 |" in table
    assert R.summary(loaded).startswith("3 traced, 1 skipped")
    port = R.port_table(loaded, "16x16")
    assert "| qwen2-0.5b | train_4k | cuda | True | 0.5 | 2.000 | " \
        "merge:4 topk:1 |" in port
    brief = R.brief_table(loaded).splitlines()
    assert len(brief) == 2 + 3
    bound = R.fmt_s(5e11 / RA.HW().hbm_bw)
    assert brief[3] == ("| qwen2-0.5b | train_4k | 1.5 / - | True / - | "
                        f"3.000 / - | memory / - | {bound} / - |")
    assert brief[2].startswith("| qwen2-0.5b | decode_32k | - / 2.5 |")


def test_report_of_collectives_by_axis():
    """Records with the trace's collectives by axis: a row an axis, its
    operands by kind in GB and the bytes sent over it."""
    recs = _records()[:1]
    recs[0]["collective"]["by_axis"] = {
        "data": {"all-gather": 2e9, "reduce-scatter": 5e8},
        "model": {"reduce-scatter": 4e9, "all-gather": 2.5e8}}
    recs[0]["sent_by_axis"] = {"data": 1e9, "model": 7.5e9}
    rows = R.axis_table(recs, "16x16").splitlines()
    assert rows[2:] == [
        "| qwen2-0.5b | train_4k | data | all-gather:2.000 "
        "reduce-scatter:0.500 | 1.000 |",
        "| qwen2-0.5b | train_4k | model | all-gather:0.250 "
        "reduce-scatter:4.000 | 7.500 |"]
    assert R.axis_table(recs, "2x16x16").count("\n") == 1
