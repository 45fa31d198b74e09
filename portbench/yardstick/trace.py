"""The profiler window and the arithmetic on its trace.

The window is a copy of ``chip_smoke.py``'s ``_profiled``: late in a
long run on the H100 a ``torch.profiler`` window can lose its first
kernel records, so marker kernels (``torch.cuda._sleep``, named
``spin_kernel``) go ahead of the body on its stream.  A trace that holds
one of them holds every kernel after it; a window that lost every marker
is taken again with twice as many.

The busy time is the union of the device operations' intervals (the
arithmetic of ``chip_smoke.py::_decode_model``).  The metrics' window
traces the device alone (``host=False``): recording every host operator
as well costs the host about 10 us an operator, which would widen the
very gaps the idle share reads.  Its length is the host clock's around
the body, which ends with a synchronise.  A second, shorter window with
the host's operators (``host=True``) names the idle gaps of the
breakdown; its window is the span of a host range around the body.
"""
from __future__ import annotations

import time
from typing import Callable, List, NamedTuple

MARKER = "spin_kernel"
WINDOW = "portbench_window"


class DeviceOp(NamedTuple):
    name: str
    start_us: float
    dur_us: float


class Trace(NamedTuple):
    """The device operations of the window (markers left out), the
    window's start and length on the trace's clock, and the host's
    operator events (name, start, duration) for naming idle gaps."""
    ops: List[DeviceOp]
    start_us: float
    window_us: float
    host: list


def profiled(body: Callable[[], None], *, host: bool = False,
             tries: int = 4) -> Trace:
    """Run ``body`` under ``torch.profiler`` (the device's activity, and
    with ``host`` the host's operators too) and return its
    :class:`Trace`."""
    import torch
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    markers = 64
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            time.sleep(0.05)
            for _ in range(markers):
                torch.cuda._sleep(100)
            with record_function(WINDOW):
                t0 = time.perf_counter()
                body()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        if any(ev.device_type == DeviceType.CUDA and MARKER in ev.name
               for ev in events):
            return _trace_of(events, host, wall_us)
        markers *= 2
    raise RuntimeError(f"no profiler window of {tries} held a marker")


def _trace_of(events, host: bool, wall_us: float) -> Trace:
    from torch.autograd import DeviceType
    cuda = [ev for ev in events if ev.device_type == DeviceType.CUDA
            and ev.name != WINDOW]
    last_marker = max((ev.time_range.end for ev in cuda
                       if MARKER in ev.name), default=float("-inf"))
    ops = sorted((DeviceOp(ev.name, ev.time_range.start,
                           ev.time_range.end - ev.time_range.start)
                  for ev in cuda if MARKER not in ev.name
                  and ev.time_range.start >= last_marker),
                 key=lambda o: o.start_us)
    if not host:
        start = ops[0].start_us if ops else 0.0
        return Trace(ops, start, wall_us, [])
    win = [ev for ev in events if ev.name == WINDOW
           and ev.device_type == DeviceType.CPU]
    if not win:
        raise RuntimeError("the profiler lost the window's host range")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    hosts = [(ev.name, ev.time_range.start,
              ev.time_range.end - ev.time_range.start) for ev in events
             if ev.device_type == DeviceType.CPU and ev.name != WINDOW
             and w0 <= ev.time_range.start <= w1]
    return Trace([op for op in ops if op.start_us >= w0], w0, w1 - w0,
                 hosts)


def busy_us(ops: List[DeviceOp]) -> float:
    """Length of the union of the operations' intervals."""
    busy, end = 0.0, float("-inf")
    for op in sorted(ops, key=lambda o: o.start_us):
        b = op.start_us + op.dur_us
        busy += max(0.0, b - max(op.start_us, end))
        end = max(end, b)
    return busy


def gaps(trace: Trace) -> list:
    """The idle intervals (start, length) of the device inside the
    window, the head and the tail included."""
    out, end = [], trace.start_us
    for op in trace.ops:
        if op.start_us > end:
            out.append((end, op.start_us - end))
        end = max(end, op.start_us + op.dur_us)
    stop = trace.start_us + trace.window_us
    if stop > end:
        out.append((end, stop - end))
    return out


def short(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces, template
    and argument lists: ``void (anonymous namespace)::topk_tiles<float,
    64>(...)`` is ``topk_tiles``."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    for stop in "<(":
        s = s.split(stop)[0]
    return s.strip()[:120] or name[:120]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and
    the longest idle gaps, each named by the innermost host operator
    that was running in the middle of the gap; seconds."""
    by_name: dict = {}
    for op in trace.ops:
        key = short(op.name)
        by_name[key] = by_name.get(key, 0.0) + op.dur_us
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(trace), key=lambda g: -g[1])[:top]
    named = []
    for start, length in idle:
        mid, inner = start + length / 2, None
        for name, h0, hd in trace.host:
            if h0 <= mid <= h0 + hd and (inner is None or hd < inner[1]):
                inner = (name, hd)
        named.append([inner[0][:120] if inner else "host (no operator)",
                      length / 1e6])
    return {"device_ops": [[k, v / 1e6] for k, v in device_ops],
            "idle_gaps": named}
