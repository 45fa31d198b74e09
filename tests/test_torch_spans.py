"""The port's spans and counters (``repro_torch/runtime/spans.py``) on the
CPU: off by default, nesting, parents, self time, counters and the
launch counter's deltas; the spans of a stacked ``DeviceEngine`` call
over 64 peers and of a granite train step under remat, and the same
bits with recording on and off."""
import copy
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.mesh import make_mesh
from repro_torch.engine import DeviceEngine, QuerySpec
from repro_torch.kernels import _build
from repro_torch.runtime import spans


class _Clock:
    """``time.time_ns`` stepping by 10 a read."""

    def __init__(self):
        self.t = 0

    def time_ns(self):
        self.t += 10
        return self.t


def test_off_records_nothing():
    assert spans._REC is None
    assert spans.span("run_many") is spans.NOOP
    assert spans.span("fd.round", round=3) is spans.NOOP
    with spans.span("x") as s:
        spans.count("engine.plan_builds")
    assert s is spans.NOOP and spans._REC is None
    with spans.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}
    assert spans.span("y") is spans.NOOP


def test_nesting_parents_self_time_and_counters(monkeypatch):
    monkeypatch.setattr(spans, "time", _Clock())
    with spans.recording() as rec:
        with spans.span("a", k=1):                   # 10 .. 80
            with spans.span("b"):                    # 20 .. 50
                with spans.span("c"):                # 30 .. 40
                    spans.count("n")
                spans.count("n", 4)
            with spans.span("d"):                    # 60 .. 70
                pass
        with spans.span("e"):                        # 90 .. 100
            pass
    names = [(s.name, s.parent, s.call, s.start_ns, s.end_ns)
             for s in rec.spans]
    assert names == [("a", None, 1, 10, 80), ("b", 0, 1, 20, 50),
                     ("c", 1, 1, 30, 40), ("d", 0, 1, 60, 70),
                     ("e", None, 2, 90, 100)]
    assert rec.spans[0].attrs == {"k": 1}
    assert spans.self_ns(rec) == [70 - 30 - 10, 30 - 10, 10, 10, 10]
    assert rec.counters == {"n": 5}


def test_a_thread_without_spans_takes_the_roots_innermost():
    """The autograd engine's thread on the card: its spans hang under
    the span the step's thread waits in, with the step's call."""
    got = {}

    def worker():
        with spans.span("replayed"):
            got["ok"] = True

    with spans.recording() as rec:
        with spans.span("train_step"):
            with spans.span("backward"):
                t = threading.Thread(target=worker)
                t.start()
                t.join()
        with spans.span("next"):
            pass
    by = {s.name: (i, s) for i, s in enumerate(rec.spans)}
    assert got["ok"]
    i_bw, bw = by["backward"]
    _, rep = by["replayed"]
    assert rep.parent == i_bw and rep.call == bw.call == 1
    assert rep.thread != bw.thread
    assert by["next"][1].call == 2


def test_recordings_do_not_nest():
    with spans.recording():
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    assert spans._REC is None


def test_launches_are_read_from_the_one_counter(monkeypatch):
    monkeypatch.setitem(_build.LAUNCHES, "topk", 5)
    table = _build.LAUNCHES
    with spans.recording() as rec:
        _build.LAUNCHES["topk"] += 3
        assert rec.launches["topk"] == 3
        _build.LAUNCHES["merge"] += 1
    assert _build.LAUNCHES is table and _build.LAUNCHES["topk"] == 8
    _build.LAUNCHES["topk"] += 1        # after the recording: not seen
    assert rec.launches["topk"] == 3 and rec.launches["merge"] == 1


def test_annotated_spans_share_the_profilers_clock():
    """With ``annotate=True`` each span is a ``record_function`` range
    of the profiler, and the span's interval lies inside it on the
    profiler's own clock."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording(annotate=True) as rec:
            with spans.span("outer"):
                with spans.span("inner"):
                    torch.ones(64).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("outer", "inner")}
    assert set(events) == {"outer", "inner"}
    for s in rec.spans:
        ev = events[s.name]
        assert ev.start_ns() <= s.start_ns <= s.end_ns <= ev.end_ns()


def test_library_builds_count_what_nvcc_compiled(monkeypatch, tmp_path):
    """``kernels.library_builds`` counts the libraries compiled, none
    where the build directory holds them all (``nvcc`` faked)."""
    class Nvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            with open(cmd[cmd.index("-o") + 1], "wb"):
                pass

        def communicate(self):
            return "", None

    monkeypatch.setattr(_build, "_BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", str)
    for built in (len(_build._sources()), 0):
        monkeypatch.setattr(_build, "_libs", None)
        with spans.recording() as rec:
            _build.ensure_built()
        assert rec.counters.get("kernels.library_builds", 0) == built


# --------------------------------------------------------------------------
# DeviceEngine.run_many over 64 peers
# --------------------------------------------------------------------------

def _engine_inputs(b=4, n=64 * 50, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(n, generator=g) for _ in range(b)]


def _names(rec, call):
    return [s.name for s in rec.spans if s.call == call]


@pytest.mark.parametrize("schedule,rounds", [("halving", 6),
                                             ("doubling", 6)])
def test_run_many_spans_and_plan_builds(schedule, rounds):
    mesh = make_mesh((64,), ("model",), device="cpu")
    eng = DeviceEngine(mesh, schedule=schedule)
    scores = _engine_inputs()
    specs = [QuerySpec(k=20)] * len(scores)
    with spans.recording() as rec:
        eng.run_many(specs, "fd-dynamic", scores=scores)     # cold
        eng.run_many(specs, "fd-dynamic", scores=scores)     # warm
    assert {s.call for s in rec.spans} == {1, 2}
    tail = ["fd.broadcast"] if schedule == "halving" else []
    want = (["run_many", "run_many.inputs", "run_many.stack", "fd.local"]
            + ["fd.round"] * rounds + tail
            + ["run_many.sync", "run_many.results"])
    assert _names(rec, 1) == _names(rec, 2) == want
    warm = [s for s in rec.spans if s.call == 2]
    assert warm[0].parent is None
    root = rec.spans.index(warm[0])
    assert all(s.parent == root for s in warm[1:])
    assert [s.attrs["round"] for s in warm if s.name == "fd.round"] == \
        list(range(rounds))
    # the cold call built the plan; nothing builds in the warm call
    assert rec.counters == {"engine.plan_builds": 1}
    with spans.recording() as warm_rec:
        eng.run_many(specs, "fd-dynamic", scores=scores)
    assert warm_rec.counters.get("engine.plan_builds", 0) == 0
    assert warm_rec.counters.get("kernels.library_builds", 0) == 0


def test_run_many_unfused_and_baselines():
    mesh = make_mesh((64,), ("model",), device="cpu")
    eng = DeviceEngine(mesh)
    one = _engine_inputs(b=1)[0]
    two = torch.stack(_engine_inputs(b=2, seed=1))       # pre-batched
    with spans.recording() as rec:
        eng.run_many([QuerySpec(k=5)] * 3, ["fd-dynamic", "cn", "cn-star"],
                     scores=[two, one, one])
    names = [s.name for s in rec.spans]
    assert names.count("run_many.unfused") == 3
    assert "run_many.stack" not in names
    par = {s.name: rec.spans[s.parent].name for s in rec.spans
           if s.parent is not None}
    assert par["fd.cn"] == par["fd.cn_star"] == "run_many.unfused"
    assert par["run_many.unfused"] == "run_many"
    # CN*'s local lists are its own phase 2
    cn_star = names.index("fd.cn_star")
    assert rec.spans[names.index("fd.local", cn_star)].parent == cn_star


@pytest.mark.parametrize("schedule", ["halving", "ring"])
def test_run_many_bits_with_recording_on_and_off(schedule):
    mesh = make_mesh((64,), ("model",), device="cpu")
    eng = DeviceEngine(mesh, schedule=schedule)
    scores = _engine_inputs(b=3, seed=2)
    specs = [QuerySpec(k=20)] * 3
    off = eng.run_many(specs, "fd-dynamic", scores=scores)
    with spans.recording():
        on = eng.run_many(specs, "fd-dynamic", scores=scores)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.values.numpy(), b.values.numpy())
        np.testing.assert_array_equal(a.indices.numpy(), b.indices.numpy())


# --------------------------------------------------------------------------
# a granite train step under remat="full"
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    from repro_torch.data.pipeline import device_put_batch
    from repro_torch.launch.train import build
    cfg, _, params, opt_state, step, data = build(
        "granite-moe-1b-a400m", smoke=True, batch=2, seq=16, model_par=1,
        microbatches=1, remat="full", lr=1e-3, steps=10, device="cpu")
    return cfg, params, opt_state, step, device_put_batch(
        data.batch_at(0), "cpu")


def test_train_step_spans_and_replay(granite):
    cfg, params, opt_state, step, batch = granite
    params, opt_state = copy.deepcopy(params), copy.deepcopy(opt_state)
    with spans.recording() as rec:
        step(params, opt_state, batch)
    s = rec.spans
    assert s[0].name == "train_step" and s[0].parent is None
    assert {x.call for x in s} == {1}

    def under(name):
        """Each span's nearest ancestor among forward / backward /
        optimizer, by the span's name."""
        out = {}
        for x in s:
            p = x.parent
            while p is not None and s[p].name not in (
                    "forward", "backward", "optimizer"):
                p = s[p].parent
            if p is not None:
                out.setdefault((x.name, s[p].name), 0)
                out[(x.name, s[p].name)] += 1
        return out.get

    n = cfg.n_layers
    phase = under(None)
    for name in ("attention", "moe", "block"):
        assert phase((name, "forward")) == n, name
        assert phase((name, "backward")) == n, name   # remat's replay
    for name in ("moe.route", "moe.dispatch", "moe.experts",
                 "moe.combine"):
        assert phase((name, "forward")) == n
    assert phase(("loss", "forward")) == phase(("embed", "forward")) == 1
    assert phase(("loss", "backward")) is None
    tops = [x.name for x in s if x.parent == 0]
    assert tops == ["forward", "backward", "optimizer"]


def test_train_step_bits_with_recording_on_and_off(granite):
    _, params, opt_state, step, batch = granite
    runs = []
    for on in (False, True):
        p, st = copy.deepcopy(params), copy.deepcopy(opt_state)
        if on:
            with spans.recording():
                p, st, m = step(p, st, batch)
        else:
            p, st, m = step(p, st, batch)
        runs.append((p, st, m))
    (p0, s0, m0), (p1, s1, m1) = runs
    assert torch.equal(m0["loss"], m1["loss"])
    for (n, a), (_, b) in zip(p0.named_parameters(), p1.named_parameters()):
        assert torch.equal(a, b), n
    for n in s0.m:
        assert torch.equal(s0.m[n], s1.m[n]) and torch.equal(s0.v[n],
                                                              s1.v[n]), n
