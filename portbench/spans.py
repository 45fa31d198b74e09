#!/usr/bin/env python3
"""The program's spans (``repro_torch/runtime/spans.py``) against the
card's trace: the arithmetic of a spans window, and a command that runs
one on a cell of ``BENCHMARK.json``.

    python3 portbench/spans.py --workload <cell> --seed <n> [--out FILE]

sets the cell up with its own driver, then runs the traffic's
``breakdown_calls`` / ``breakdown_steps`` calls or steps
(``drivers/<driver>.py::window`` for no time: one call or step each)
under ``recording()`` and the profiler, and prints one JSON object: the
counts below, the card's idle time by span and each span's kernel
launches.  The counts are by span name and name no metric: a reader of
one divides the names it needs.

The window takes the cell's kind from its traffic: a query cell traces
the card alone (``annotate=False``: host times carry no profiler cost a
host operator), a training cell the host's operators and the card's
kernels with ``annotate=True``, so that each kernel can be followed to
the span that launched it:

* a kernel goes to the innermost span open, on the host operator's
  thread, when the operator that launched it began (the profiler links
  the two by correlation);
* a kernel launched inside an ``autograd::engine::evaluate_function``
  range that opened after that thread's innermost span is a backward
  kernel: it goes, through the range's ``sequence_nr`` and forward
  thread, to the forward operator that made the node (the last on that
  thread to record the number), and from there to that operator's span
  (remat's replay runs inside such a range, in its own spans, which
  opened after the range: it stays with them);
* a user annotation (``record_function``, on the host or the card) is
  never device work.

Spans are stamped on the profiler's clock (``time.time_ns()``), so the
card's idle gaps are named by the innermost span open at each gap's
midpoint, and a kernel's launch (the runtime's event) by the innermost
span open when it was made.

:func:`profiled`, :data:`MARKER` and :func:`device_work`'s cut at the
last marker are a copy of ``portbench/yardstick/trace.py::profiled``'s
marker-guarded window; this one yields the raw kineto events and runs
the body under ``recording()``.
"""
from __future__ import annotations

import bisect
import json
import re
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

BACKWARD = "autograd::engine::evaluate_function"
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")
MARKER = "spin_kernel"


class Ev(NamedTuple):
    """One profiler event, as the arithmetic reads it."""
    name: str
    kind: str             # kineto's activity type: cpu_op, kernel, ...
    device: bool          # on the card: a kernel, a copy or a fill
    start_ns: int
    dur_ns: int
    corr: int             # the event's correlation id
    link: int             # a device event's launching host operator
    tid: int              # the host thread (the profiler's numbering)
    seq: int              # sequence_nr, -1 where none
    fwd_tid: int          # a backward range's forward thread, else 0
    annotation: bool      # a record_function range, host or card


def events_of(prof, names=()) -> List[Ev]:
    """The profiler's events, read from its kineto results (not through
    ``prof.events()``, which builds a tree of every operator).  An event
    named as a span (``names``) is a user annotation where kineto does
    not flag it; a host event that PyTorch did not record (no
    ``aten::``-like name: ``cudaLaunchKernel``, ``cuMemcpyAsync``) is
    the CUDA runtime's or driver's where kineto gives no activity type."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    base = res.trace_start_ns()
    names = frozenset(names)
    out = []
    for e in res.events():
        start = e.start_ns()
        if start < base // 2:                  # relative to the trace
            start += base
        name = e.name()
        on_card = e.device_type() != DeviceType.CPU
        flag = getattr(e, "is_user_annotation", None)
        ann = bool(flag()) if flag is not None else False
        kind_of = getattr(e, "activity_type", None)
        if kind_of is not None:
            kind = str(kind_of()).lower().split(".")[-1]
        elif on_card:
            kind = "kernel"
        elif _RUNTIME.match(name):
            kind = "cuda_runtime"
        else:
            kind = "cpu_op"
        ann = ann or "annotation" in kind or name in names
        out.append(Ev(name, kind, on_card and not ann, start,
                      e.duration_ns(), e.correlation_id(),
                      e.linked_correlation_id(), e.start_thread_id(),
                      e.sequence_nr(), e.fwd_thread_id(), ann))
    return out


def _runtime(e: Ev) -> bool:
    """A call of the CUDA runtime or driver on the host."""
    return not e.device and ("runtime" in e.kind or "driver" in e.kind)


def _op(e: Ev) -> bool:
    """A host operator (an aten op, an autograd node's range)."""
    return not e.device and not e.annotation and not _runtime(e)


def device_work(events: List[Ev]) -> List[Ev]:
    """The card's work after the window's last marker kernel: kernels,
    copies and fills, no user annotation."""
    dev = [e for e in events if e.device]
    last = max((e.start_ns + e.dur_ns for e in dev if MARKER in e.name),
               default=None)
    return [e for e in dev if MARKER not in e.name
            and (last is None or e.start_ns >= last)]


def profiled(body, *, host: bool, annotate: bool, tries: int = 4):
    """``body`` under ``recording(annotate)`` and ``torch.profiler``
    (the card's activity, and with ``host`` the host's): (the record,
    the events).  Marker kernels go ahead of the body, as in
    ``yardstick/trace.py::profiled``, of which this is a copy: a window
    that lost its first kernel records holds no marker, and is taken
    again with twice as many."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.spans import recording
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    markers = 64
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            time.sleep(0.05)
            for _ in range(markers):
                torch.cuda._sleep(100)
            with recording(annotate=annotate) as rec:
                body()
                torch.cuda.synchronize()
        events = events_of(prof, {s.name for s in rec.spans})
        if any(e.device and MARKER in e.name for e in events):
            return rec, events
        markers *= 2
    raise RuntimeError(f"no profiler window of {tries} held a marker")


# --------------------------------------------------------------------------
# spans on the host's clock
# --------------------------------------------------------------------------

def self_by_name(rec) -> Dict[str, int]:
    """Summed self time (ns) of the spans of each name."""
    from repro_torch.runtime.spans import self_ns
    out: Dict[str, int] = {}
    for s, t in zip(rec.spans, self_ns(rec)):
        out[s.name] = out.get(s.name, 0) + t
    return out


def covered_ns(rec, pick) -> int:
    """Time (ns) the spans ``pick(name)`` selects cover: the summed
    durations of those with no selected ancestor."""
    total = 0
    for s in rec.spans:
        if not pick(s.name):
            continue
        p = s.parent
        while p is not None and not pick(rec.spans[p].name):
            p = rec.spans[p].parent
        if p is None:
            total += s.dur_ns
    return total


def host_counts(rec) -> dict:
    """The host's counts by span name, ns: ``spans_host_ns`` the time
    the spans of each name cover (a span inside one of its own name
    counted once), ``spans_self_ns`` their summed self time; and
    ``spans_calls``, the calls or steps the record holds."""
    names = {s.name for s in rec.spans}
    return {
        "spans_host_ns": {n: covered_ns(rec, lambda m, n=n: m == n)
                          for n in names},
        "spans_self_ns": self_by_name(rec),
        "spans_calls": len({s.call for s in rec.spans}),
    }


# --------------------------------------------------------------------------
# the card's time by span
# --------------------------------------------------------------------------

class _Threads:
    """Intervals by thread, for the innermost one open at a time: each
    thread's intervals nest, so the innermost open at t is the last to
    start by t, or an ancestor of it."""

    def __init__(self, items):
        self.by: Dict[int, tuple] = {}
        groups: Dict[int, list] = {}
        for key, tid, a, b in items:
            groups.setdefault(tid, []).append((a, b, key))
        for tid, xs in groups.items():
            xs.sort(key=lambda x: (x[0], -x[1]))
            self.by[tid] = ([x[0] for x in xs], xs)

    def at(self, tid, t):
        """(start, key) of the innermost interval of ``tid`` open at
        ``t``, or None."""
        got = self.by.get(tid)
        if got is None:
            return None
        starts, xs = got
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            a, b, key = xs[i]
            if a <= t <= b:
                return a, key
            i -= 1
        return None


def _span_threads(rec, events: List[Ev]) -> dict:
    """The profiler's thread number of each native thread, read off the
    spans' own ``record_function`` ranges (``annotate=True``): the
    tightest host range of a span's name around it."""
    ranges: Dict[str, list] = {}
    for e in events:
        if e.annotation and not e.device:
            ranges.setdefault(e.name, []).append(e)
    out = {}
    for s in rec.spans:
        best = None
        for e in ranges.get(s.name, ()):
            if e.start_ns <= s.start_ns and s.end_ns <= e.start_ns + e.dur_ns \
                    and (best is None or e.dur_ns < best.dur_ns):
                best = e
        if best is not None:
            out[best.tid] = s.thread
    return out


def attribute(rec, events: List[Ev]) -> dict:
    """The card's time (ns) by span index (None: no span), by the rules
    of the module's docstring; ``kernels``: by (span index, kernel's
    short name); ``launch_in_span``: of the device events
    that went straight to the span their operator ran in, the share
    whose launch (the runtime's event, on CUPTI's clock) falls inside
    that span's interval (on the spans' clock)."""
    from portbench.yardstick.trace import short
    spans = rec.spans
    native = _span_threads(rec, events)
    open_at = _Threads((i, s.thread, s.start_ns, s.end_ns)
                       for i, s in enumerate(spans))
    ops = {e.corr: e for e in events if _op(e)}
    launch = {e.corr: e for e in events if _runtime(e)}
    backward = _Threads((e, e.tid, e.start_ns, e.start_ns + e.dur_ns)
                        for e in ops.values() if e.name.startswith(BACKWARD))
    # an operator records the thread's next sequence number whether or
    # not it makes a node, so the last to record one made that node (or
    # runs inside the operator that did)
    fwd: Dict[tuple, Ev] = {}
    for e in sorted(ops.values(), key=lambda e: e.start_ns):
        if e.seq >= 0 and not e.fwd_tid:
            fwd[(e.tid, e.seq)] = e

    def any_thread(t):
        best = None
        for tid in open_at.by:
            got = open_at.at(tid, t)
            if got is not None and (best is None or got[0] > best[0]):
                best = got
        return None if best is None else best[1]

    def span_at(tid, t):
        got = open_at.at(native.get(tid), t)
        return got[1] if got is not None else any_thread(t)

    by: Dict[Optional[int], int] = {}
    kernels: Dict[tuple, int] = {}
    inside = direct = 0
    for k in device_work(events):
        op = ops.get(k.link)
        where = None
        if op is not None:
            s = open_at.at(native.get(op.tid), op.start_ns)
            bw = backward.at(op.tid, op.start_ns)
            f = None
            if bw is not None and (s is None or s[0] < bw[0]):
                f = fwd.get((bw[1].fwd_tid, bw[1].seq))
            if f is not None:
                where = span_at(f.tid, f.start_ns)
            else:
                where = s[1] if s is not None else any_thread(op.start_ns)
                rt = launch.get(k.corr)
                if where is not None and rt is not None:
                    direct += 1
                    w = spans[where]
                    inside += w.start_ns <= rt.start_ns <= w.end_ns
        by[where] = by.get(where, 0) + k.dur_ns
        key = (where, short(k.name))
        kernels[key] = kernels.get(key, 0) + k.dur_ns
    return {"by_span": by, "kernels": kernels,
            "launch_in_span": inside / direct if direct else None}


def share_by_name(rec, by_span: dict) -> Dict[str, int]:
    """The card's time (ns) below each span name: what went to a span
    of that name or to a span under one (each name once a kernel)."""
    out: Dict[str, int] = {}
    for i, ns in by_span.items():
        names = set()
        while i is not None:
            names.add(rec.spans[i].name)
            i = rec.spans[i].parent
        for n in names:
            out[n] = out.get(n, 0) + ns
    return out


def device_counts(rec, events: List[Ev], top: int = 6) -> dict:
    """The card's counts by span name, ns: the window's device time, the
    time no span took, the time below each span name, and below each
    name its ``top`` kernels by time."""
    got = attribute(rec, events)
    by = got["by_span"]
    below: Dict[str, Dict[str, int]] = {}
    for (i, kernel), ns in got["kernels"].items():
        names = set()
        while i is not None:
            names.add(rec.spans[i].name)
            i = rec.spans[i].parent
        for n in names:
            ks = below.setdefault(n, {})
            ks[kernel] = ks.get(kernel, 0) + ns
    return {"spans_device_ns": sum(by.values()),
            "spans_unattributed_ns": by.get(None, 0),
            "spans_device_by_name": share_by_name(rec, by),
            "spans_top_kernels": {
                n: dict(sorted(ks.items(), key=lambda kv: -kv[1])[:top])
                for n, ks in below.items()},
            "spans_launch_in_span": got["launch_in_span"]}


# --------------------------------------------------------------------------
# the idle card by span, and the launches each span encloses
# --------------------------------------------------------------------------

def idle_by_span(rec, events: List[Ev]) -> Dict[str, int]:
    """The card's idle time (ns) between the first root span's start and
    the last one's end, by the innermost span open on the root's thread
    ("(none)" outside every span): each gap is cut at the spans' starts
    and ends, and each piece goes to the span open at its midpoint."""
    roots = [s for s in rec.spans if s.parent is None]
    if not roots:
        return {}
    lo, hi = roots[0].start_ns, max(s.end_ns for s in roots)
    tid = roots[0].thread
    mine = [(i, s) for i, s in enumerate(rec.spans) if s.thread == tid]
    open_at = _Threads((i, tid, s.start_ns, s.end_ns) for i, s in mine)
    cuts = sorted({t for _, s in mine for t in (s.start_ns, s.end_ns)})
    out: Dict[str, int] = {}

    def piece(a, b):
        got = open_at.at(tid, (a + b) // 2)
        name = rec.spans[got[1]].name if got else "(none)"
        out[name] = out.get(name, 0) + b - a

    end = lo
    work = sorted((e.start_ns, e.start_ns + e.dur_ns)
                  for e in device_work(events))
    for a, b in work + [(hi, hi)]:
        a, b = max(a, lo), min(b, hi)
        if a > end:
            i = bisect.bisect_right(cuts, end)
            j = bisect.bisect_left(cuts, a)
            edges = [end] + cuts[i:j] + [a]
            for x, y in zip(edges, edges[1:]):
                if y > x:
                    piece(x, y)
        end = max(end, b)
    return out


def launches_by_span(rec, events: List[Ev]) -> Dict[str, Dict[str, int]]:
    """The shared clock without the host's operators: the card's kernels
    by the innermost span open (on any thread, on the spans' clock) when
    the runtime made their launch (on CUPTI's clock), as {span name:
    {kernel's short name: launches}}; "(none)" outside every span."""
    from portbench.yardstick.trace import short
    open_at = _Threads((i, s.thread, s.start_ns, s.end_ns)
                       for i, s in enumerate(rec.spans))
    launch = {e.corr: e for e in events if _runtime(e)}
    out: Dict[str, Dict[str, int]] = {}
    for k in device_work(events):
        rt = launch.get(k.corr)
        if rt is None:
            continue
        best = None
        for tid in open_at.by:
            got = open_at.at(tid, rt.start_ns)
            if got is not None and (best is None or got[0] > best[0]):
                best = got
        name = rec.spans[best[1]].name if best else "(none)"
        ks = out.setdefault(name, {})
        ks[short(k.name)] = ks.get(short(k.name), 0) + 1
    return out


# --------------------------------------------------------------------------
# the command
# --------------------------------------------------------------------------

def _pct(part: Dict[str, int], whole: int) -> Dict[str, float]:
    return {k: round(100.0 * v / whole, 2)
            for k, v in sorted(part.items(), key=lambda kv: -kv[1])} \
        if whole else {}


def main(argv) -> int:
    import argparse
    import os

    ap = argparse.ArgumentParser(prog="portbench/spans.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from portbench import harness
    for var, path in harness.CACHES.items():
        os.environ[var] = str(path)
    import torch
    torch.set_num_threads(harness.THREADS)
    c = harness.cell(args.workload)
    drv = harness.driver(c)
    run = harness.Run(c, args.seed, "cuda")
    st = drv.setup(run)
    run.log("set-up done")
    train = c.traffic["driver"] == "train"
    n = c.traffic["breakdown_steps" if train else "breakdown_calls"]

    def body():
        for _ in range(n):
            drv.window(st, 0.0)

    rec, events = profiled(body, host=train, annotate=train)
    run.log(f"spans window of {n}: {len(rec.spans)} spans, "
            f"{len(events)} events")
    counts = host_counts(rec)
    if train:
        counts.update(device_counts(rec, events))
    idle = idle_by_span(rec, events)
    roots = sum(s.dur_ns for s in rec.spans if s.parent is None)
    run.log(f"host self time, % of the roots: "
            f"{_pct(counts['spans_self_ns'], roots)}")
    if train:
        below = _pct(counts["spans_device_by_name"],
                     counts["spans_device_ns"])
        run.log(f"device time below each span, %: {below}")
    run.log(f"idle by span, % of {sum(idle.values()) / 1e6:.3f} ms: "
            f"{_pct(idle, sum(idle.values()))}")
    run.log(f"builds: {rec.counters}")
    out = {"cell": c.name, "seed": args.seed, "n": n,
           "card": harness.power_limit(), "torch": torch.__version__,
           "counters": rec.counters, "launches": rec.launches,
           "counts": counts, "idle_ns_by_span": idle,
           "launches_by_span": launches_by_span(rec, events)}
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    _ROOT = Path(__file__).resolve().parents[1]
    sys.pycache_prefix = str(_ROOT / "build" / "pycache")
    sys.path[0] = str(_ROOT)
    sys.path.insert(1, str(_ROOT / "src"))
    sys.exit(main(sys.argv[1:]))
