"""The busy-interval union, the idle gaps, the breakdown and the
per-layer readers on a trace made by hand."""
import pytest

from portbench import harness
from portbench.yardstick import trace as T

OPS = [T.DeviceOp("void topk_tiles<float>(float const*)", 10.0, 20.0),
       T.DeviceOp("void topk_final<float>(x)", 25.0, 10.0),
       T.DeviceOp("Memcpy DtoD (Device -> Device)", 50.0, 5.0),
       T.DeviceOp("void merge_kernel<float>(y)", 70.0, 10.0)]
TRACE = T.Trace(OPS, 0.0, 100.0, [("aten::stack", 30.0, 25.0),
                                  ("run_many", 0.0, 100.0)])


def test_busy_union_and_gaps():
    assert T.busy_us(OPS) == 25.0 + 5.0 + 10.0
    assert T.gaps(TRACE) == [(0.0, 10.0), (35.0, 15.0), (55.0, 15.0),
                             (80.0, 20.0)]


def test_breakdown():
    b = T.breakdown(TRACE)
    assert b["device_ops"][0] == ["topk_tiles", 20e-6]
    assert b["idle_gaps"][0] == ["run_many", 20e-6]
    assert ["aten::stack", 15e-6] in b["idle_gaps"]


def _ctx(counts):
    return {"trace": TRACE, "counts": counts, "busy_s": 40e-6,
            "window_s": 100e-6}


def test_query_readers():
    counts = {"calls": 1, "queries": 2, "peers": 4, "items_per_peer": 1000,
              "k": 5}
    ctx = _ctx(counts)
    assert harness.reader("kernels_per_call.query")(ctx) == 3
    assert harness.reader("idle_pct.query")(ctx) == pytest.approx(60.0)
    # 2 x 4 x (4,000 + 40) B over the 30 us of topk_* kernels
    assert harness.reader("topk_roofline_pct.query")(ctx) == pytest.approx(
        100 * 32_320 / 3.35e12 / 30e-6)
    # 2 x (4,000 x 4 + 40) B over the 100 us window
    assert harness.reader("fd_roofline_pct.query")(ctx) == pytest.approx(
        100 * 32_080 / 3.35e12 / 100e-6)


def test_train_readers():
    ctx = _ctx({"steps": 3, "tokens_per_step": 1000,
                "flops_per_token": 1e6, "peak_window_bytes": 2 ** 31})
    assert harness.reader("kernels_per_step.train")(ctx) == 1
    assert harness.reader("mfu_pct.train")(ctx) == pytest.approx(
        100 * 3e9 / 100e-6 / 989e12)
    assert harness.reader("peak_mem_gib.train")(ctx) == 2.0


def test_readers_silent_without_their_kernels():
    ctx = _ctx({"calls": 1, "queries": 2, "peers": 4,
                "items_per_peer": 1000, "k": 5})
    ctx["trace"] = T.Trace([T.DeviceOp("gemm", 0.0, 5.0)], 0.0, 10.0, [])
    assert harness.reader("topk_roofline_pct.query")(ctx) is None


def test_traced_run_result(monkeypatch):
    """A ``--trace 1`` run's line: the cell's per-layer metrics read from
    the driver's traced window, busy_s and window_s, the breakdown of
    the host window, and the checks last."""
    import types

    c = harness.cell("fd-query-64")
    counts = {"calls": 1, "queries": 2, "peers": 4, "items_per_peer": 1000,
              "k": 5, "attempted": 2, "failed": 0}
    fake = types.SimpleNamespace(
        setup=lambda run: "state",
        traced=lambda st: (TRACE, TRACE, counts),
        release=lambda st: None,
        check=lambda st: [("wrong_answers", 0, 0)])
    monkeypatch.setattr(harness, "driver", lambda cell: fake)
    res = harness.execute(c, 1, 1.0, True, "cpu", 0.0)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert res["correct"] and res["attempted"] == 2
    assert set(res["metrics"]) == {m["name"] for m in c.per_layer}
    assert res["device"]["busy_s"] == pytest.approx(40e-6)
    assert res["device"]["window_s"] == pytest.approx(100e-6)
