"""``portbench/spans.py`` on a record and an event list made by hand: the
host's counts by span name on the spans' own clock, the idle split and
the launches by span, the card's time by span name from kernels followed
to their spans (by the launching operator, and through a backward
range's ``sequence_nr``), user annotations left out, and empty counts
from an empty window."""
import pytest

from portbench import spans as P
from repro_torch.runtime import spans as S

MAIN, AUTOGRAD = 100, 200          # native thread ids
T_MAIN, T_AUTOGRAD = 1, 2          # the profiler's numbering


def _record(rows):
    """A closed record of (name, start, end, parent, thread) rows."""
    rec = S.Record()
    rec.spans = [S.Span(n, {}, a, b, p, th, 1) for n, a, b, p, th in rows]
    return rec


def _ev(name, kind, start, dur, corr=0, link=0, tid=T_MAIN, seq=-1,
        fwd_tid=0):
    device = kind in ("kernel", "gpu_memcpy")
    ann = "annotation" in kind
    return P.Ev(name, kind, device, start, dur, corr, link, tid, seq,
                fwd_tid, ann)


# --------------------------------------------------------------------------
# a query call
# --------------------------------------------------------------------------

QUERY = _record([("run_many", 0, 100, None, MAIN),
                 ("run_many.inputs", 0, 20, 0, MAIN),
                 ("run_many.stack", 20, 30, 0, MAIN),
                 ("fd.local", 30, 40, 0, MAIN),
                 ("fd.round", 40, 50, 0, MAIN),
                 ("run_many.sync", 50, 60, 0, MAIN),
                 ("run_many.results", 60, 100, 0, MAIN)])
QUERY_EVENTS = [_ev("spin_kernel", "kernel", -50, 10),
                _ev("void topk_tiles<float>(x)", "kernel", 25, 10, corr=7),
                _ev("cudaLaunchKernel", "cuda_runtime", 32, 1, corr=7),
                _ev("merge_kernel_warp", "kernel", 42, 13, corr=8),
                _ev("cudaLaunchKernel", "cuda_runtime", 44, 1, corr=8)]


def test_query_counts_and_readings():
    c = P.host_counts(QUERY)
    host, own = c["spans_host_ns"], c["spans_self_ns"]
    assert host == {"run_many": 100, "run_many.inputs": 20,
                    "run_many.stack": 10, "fd.local": 10, "fd.round": 10,
                    "run_many.sync": 10, "run_many.results": 40}
    assert own["run_many"] == 0 and own["run_many.results"] == 40
    assert c["spans_calls"] == 1
    # a reader's shares of a call: its results, and building and
    # launching it (inputs, stack and the fd.* spans)
    assert 100 * own["run_many.results"] / host["run_many"] == 40.0
    launch = sum(v for k, v in host.items()
                 if k in ("run_many.inputs", "run_many.stack")
                 or k.startswith("fd."))
    assert 100 * launch / host["run_many"] == 50.0


def test_idle_split_and_launches_inside_spans():
    idle = P.idle_by_span(QUERY, QUERY_EVENTS)
    # gaps [0, 25], [35, 42], [55, 100], cut where spans open and close
    assert idle == {"run_many.inputs": 20, "run_many.stack": 5,
                    "fd.local": 5, "fd.round": 2, "run_many.sync": 5,
                    "run_many.results": 40}
    assert P.launches_by_span(QUERY, QUERY_EVENTS) == {
        "fd.local": {"topk_tiles": 1}, "fd.round": {"merge_kernel_warp": 1}}


def test_covered_counts_nested_spans_once():
    rec = _record([("run_many", 0, 100, None, MAIN),
                   ("fd.cn_star", 10, 60, 0, MAIN),
                   ("fd.local", 20, 30, 1, MAIN),
                   ("fd.local", 22, 28, 2, MAIN)])
    assert P.covered_ns(rec, lambda n: n.startswith("fd.")) == 50
    assert P.host_counts(rec)["spans_host_ns"]["fd.local"] == 10


# --------------------------------------------------------------------------
# a training step under remat
# --------------------------------------------------------------------------

STEP = _record([("train_step", 0, 1000, None, MAIN),          # 0
                ("forward", 10, 400, 0, MAIN),                # 1
                ("attention", 20, 100, 1, MAIN),              # 2
                ("moe", 110, 300, 1, MAIN),                   # 3
                ("moe.dispatch", 150, 250, 3, MAIN),          # 4
                ("loss", 310, 390, 1, MAIN),                  # 5
                ("backward", 400, 900, 0, MAIN),              # 6
                ("attention", 450, 500, 6, AUTOGRAD),         # 7 replay
                ("optimizer", 900, 990, 0, MAIN)])            # 8


def _step_events():
    ev = [_ev("spin_kernel", "kernel", -50, 10)]
    # each span's own record_function range, a little wider
    for s in STEP.spans:
        tid = T_AUTOGRAD if s.thread == AUTOGRAD else T_MAIN
        ev.append(_ev(s.name, "user_annotation", s.start_ns - 1,
                      s.dur_ns + 2, tid=tid))
    ev.append(_ev("attention", "gpu_user_annotation", 20, 500))
    ops = [  # (name, start, corr, tid, seq)
        ("aten::bmm", 30, 1001, T_MAIN, 5),                 # attention
        ("aten::to", 105, 1010, T_MAIN, 7),                 # makes no node
        ("aten::index_put_", 160, 1002, T_MAIN, 7),         # moe.dispatch
        ("aten::logsumexp", 320, 1003, T_MAIN, 9),          # loss
        ("aten::bmm", 460, 1004, T_AUTOGRAD, 3),            # replay
        ("aten::index", 610, 1006, T_AUTOGRAD, -1),         # in E2
        ("aten::bmm", 710, 1007, T_AUTOGRAD, -1),           # in E3
        ("aten::_foreach_add_", 910, 1008, T_MAIN, -1),     # optimizer
        ("aten::copy_", 1010, 1009, T_MAIN, -1)]            # no span
    for name, t, corr, tid, seq in ops:
        ev.append(_ev(name, "cpu_op", t, 5, corr=corr, tid=tid, seq=seq))
    # backward ranges: the replay's node was made on the autograd thread
    ev += [_ev(P.BACKWARD + ": BmmBackward0", "cpu_op", 440, 80,
               corr=2001, tid=T_AUTOGRAD, seq=11, fwd_tid=T_MAIN),
           _ev(P.BACKWARD + ": IndexPutBackward0", "cpu_op", 600, 50,
               corr=2002, tid=T_AUTOGRAD, seq=7, fwd_tid=T_MAIN),
           _ev(P.BACKWARD + ": BmmBackward0", "cpu_op", 700, 50,
               corr=2003, tid=T_AUTOGRAD, seq=3, fwd_tid=T_AUTOGRAD)]
    kernels = [(1001, 10), (1002, 20), (1003, 5), (1004, 7), (1006, 30),
               (1007, 11), (1008, 3), (1009, 2)]
    for i, (op, dur) in enumerate(kernels):
        start = next(e.start_ns for e in ev if e.corr == op)
        ev.append(_ev(f"kernel_{i}", "kernel", start + 2, dur,
                      corr=5000 + i, link=op))
        ev.append(_ev("cudaLaunchKernel", "cuda_runtime", start + 1, 1,
                      corr=5000 + i, tid=0))
    return ev


def test_train_kernels_go_to_their_spans():
    c = P.device_counts(STEP, _step_events())
    assert c["spans_device_ns"] == 10 + 20 + 5 + 7 + 30 + 11 + 3 + 2
    assert c["spans_unattributed_ns"] == 2
    by = c["spans_device_by_name"]
    # forward 10, remat's replay 7, the replay's backward 11
    assert by["attention"] == 10 + 7 + 11
    # the dispatch 20, its backward 30 through sequence_nr 7 (to the
    # last operator that recorded it, not aten::to before the span)
    assert by["moe"] == 20 + 30
    assert by["loss"] == 5 and by["optimizer"] == 3 and "embed" not in by
    assert by["moe.dispatch"] == 50 and by["backward"] == 7 + 11
    assert by["train_step"] == 88 - 2
    assert c["spans_top_kernels"]["attention"] == {
        "kernel_0": 10, "kernel_3": 7, "kernel_5": 11}
    assert c["spans_top_kernels"]["moe"] == {"kernel_1": 20, "kernel_4": 30}
    # top kernels below every name, none for a span with no kernel
    assert c["spans_top_kernels"]["backward"] == {"kernel_3": 7,
                                                  "kernel_5": 11}
    assert set(c["spans_top_kernels"]) == set(by)
    # every launch that went straight to a span lies inside it
    assert c["spans_launch_in_span"] == 1.0


def test_annotations_are_never_device_work():
    ev = _step_events()
    assert not any(e.device for e in ev if e.annotation)
    assert all("annotation" not in e.kind for e in P.device_work(ev))
    assert "spin_kernel" not in {e.name for e in P.device_work(ev)}


@pytest.mark.parametrize("counts", ["host_counts", "device_counts",
                                    "idle_by_span", "launches_by_span"])
def test_counts_of_an_empty_window(counts):
    """A window with no span and no event counts nothing, and names no
    span a reader would divide by."""
    empty = S.Record()
    fn = getattr(P, counts)
    got = fn(empty) if counts == "host_counts" else fn(empty, [])
    if counts == "host_counts":
        assert got == {"spans_host_ns": {}, "spans_self_ns": {},
                       "spans_calls": 0}
    elif counts == "device_counts":
        assert got == {"spans_device_ns": 0, "spans_unattributed_ns": 0,
                       "spans_device_by_name": {}, "spans_top_kernels": {},
                       "spans_launch_in_span": None}
    else:
        assert got == {}


def test_events_of_a_cpu_profile():
    """The kineto fields as ``events_of`` reads them on the CPU: the
    spans' ranges are annotations on the spans' clock, operators carry
    their sequence numbers, a backward range its forward thread."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(4, 4, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with S.recording(annotate=True) as rec:
            with S.span("forward"):
                y = (x @ x).sum()
            with S.span("backward"):
                torch.autograd.grad(y, [x])
    ev = P.events_of(prof)
    ann = {e.name: e for e in ev if e.annotation}
    assert set(ann) == {"forward", "backward"}
    assert P._span_threads(rec, ev) == {ann["forward"].tid:
                                        rec.spans[0].thread}
    bw = [e for e in ev if e.name.startswith(P.BACKWARD)
          and "MmBackward" in e.name]
    mm = [e for e in ev if e.name == "aten::mm" and e.seq >= 0]
    assert bw and mm and bw[0].seq == mm[0].seq
    assert bw[0].fwd_tid == mm[0].tid and not mm[0].fwd_tid
    assert all(P._op(e) for e in bw + mm) and not any(e.device for e in ev)


def test_events_of_without_activity_types():
    """Where kineto gives no activity type (PyTorch 2.11), the kinds are
    read off the device and the name, a span's name on the card is an
    annotation, and starts relative to the trace are made absolute."""
    import types

    from torch.autograd import DeviceType

    def ev(name, dev):
        return types.SimpleNamespace(
            name=lambda: name, device_type=lambda: dev,
            start_ns=lambda: 10, duration_ns=lambda: 1,
            is_user_annotation=lambda: False, correlation_id=lambda: 1,
            linked_correlation_id=lambda: 0, start_thread_id=lambda: 1,
            sequence_nr=lambda: -1, fwd_thread_id=lambda: 0)
    raw = [ev("cudaLaunchKernel", DeviceType.CPU),
           ev("cuLaunchKernelEx", DeviceType.CPU),
           ev("aten::mm", DeviceType.CPU),
           ev("void gemm<float>()", DeviceType.CUDA),
           ev("attention", DeviceType.CUDA)]
    res = types.SimpleNamespace(trace_start_ns=lambda: 10 ** 18,
                                events=lambda: raw)
    prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=res))
    got = P.events_of(prof, {"attention"})
    assert [e.kind for e in got] == ["cuda_runtime", "cuda_runtime",
                                     "cpu_op", "kernel", "kernel"]
    assert [e.device for e in got] == [False, False, False, True, False]
    assert got[4].annotation and not got[3].annotation
    assert [P._runtime(e) for e in got[:3]] == [True, True, False]
    assert all(e.start_ns == 10 ** 18 + 10 for e in got)
