"""Stacked top-k queries through the port's ``DeviceEngine`` (FD over the
peers of a mesh on one card), in a closed loop.

The configuration gives the deployment (``peers``, ``items_per_peer``,
``k``, ``schedule``, ``policy``); the traffic gives ``queries_per_call``
(stacked into one collective call), ``pool_calls`` (the pool holds that
many calls' worth of distinct score vectors, made on the card from the
seed), ``selections`` (how many seeded choices of a call's rows from the
pool the loop cycles through), ``checked_share`` (the share of calls
whose answers are kept for the check, drawn from the seed call by
call), ``warm_calls``, ``trace_calls`` and ``breakdown_calls`` (the two
traced windows of ``--trace 1``).

A query's response time runs from the start of the call that answered
it to the call's return, read on the card's clock (CUDA events recorded
at both ends; the stream is idle at the start, since each call ends in a
synchronise; on the CPU, where there are no events, the host's clock).
Every answer of the kept calls is held to the plain reference
(``reference/topk.py``) after the window: its k values and indices,
exactly.
"""
from __future__ import annotations

import dataclasses
import functools
import random
import time

import numpy as np

from portbench.reference.topk import topk_rows


class _HostEvent:
    """The host clock behind a CUDA event's ``record`` and
    ``elapsed_time`` (milliseconds), where there is no card."""

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.t - self.t) * 1e3


@dataclasses.dataclass
class State:
    run: object
    engine: object
    specs: list
    policy: str
    pool: object
    selections: list          # index arrays into the pool, one a choice
    views: list               # the pool's rows of each choice
    kept: object              # () -> whether the next call is checked
    calls: int = 0
    answers: list = dataclasses.field(default_factory=list)


def setup(run) -> State:
    import torch

    from repro_torch.core.mesh import make_mesh
    from repro_torch.engine import DeviceEngine, QuerySpec

    run.log("program imported")
    dep, tr = run.cell.config["deployment"], run.cell.traffic
    peers, k = dep["peers"], dep["k"]
    n = peers * dep["items_per_peer"]
    b = tr["queries_per_call"]
    rows = b * tr["pool_calls"]
    gen = torch.Generator(run.device).manual_seed(run.seed % 2 ** 63)
    pool = torch.empty((rows, n), dtype=torch.float32, device=run.device)
    for r0 in range(0, rows, b):
        pool[r0:r0 + b].normal_(generator=gen)
    if run.device == "cuda":
        torch.cuda.synchronize()
    rng = np.random.default_rng(run.seed % 2 ** 63)
    selections = [rng.permutation(rows)[:b]
                  for _ in range(tr["selections"])]
    views = [[pool[int(r)] for r in sel] for sel in selections]
    share = tr["checked_share"]
    draw = random.Random(run.seed).random
    run.log(f"pool of {rows} x {n} scores made")
    mesh = make_mesh((peers,), ("model",), device=run.device)
    engine = DeviceEngine(mesh, schedule=dep["schedule"],
                          precision="bf16" if run.control else None)
    st = State(run, engine, [QuerySpec(k=k)] * b, dep["policy"], pool,
               selections, views, lambda: draw() < share)
    for _ in range(1 + tr["warm_calls"]):
        _call(st)
    run.log("warm calls done")
    return st


def _call(st: State) -> None:
    """The next call: the rows of its selection stacked into one call.
    The answers of a call drawn for the check are kept."""
    s = st.calls % len(st.views)
    st.calls += 1
    res = st.engine.run_many(st.specs, st.policy, scores=st.views[s])
    if st.kept():
        st.answers.append((s, [r.values for r in res],
                           [r.indices for r in res]))


def window(st: State, seconds: float) -> dict:
    import torch
    event = (functools.partial(torch.cuda.Event, enable_timing=True)
             if st.run.device == "cuda" else _HostEvent)
    marks = []
    done0 = st.calls
    t0 = time.perf_counter()
    while True:
        e0, e1 = event(), event()
        e0.record()
        _call(st)
        e1.record()
        marks.append((e0, e1))
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    if st.run.device == "cuda":
        torch.cuda.synchronize()
    lat_ms = sorted(a.elapsed_time(b) for a, b in marks)
    calls = st.calls - done0
    b = len(st.specs)
    # nearest rank: every query of a call shares the call's time
    p95 = lat_ms[max(0, -(-95 * len(lat_ms) // 100) - 1)]
    return {"metrics": {"topk_queries_s": calls * b / elapsed,
                        "query_p95_ms": p95},
            "attempted": calls * b, "failed": 0}


def traced(st: State):
    """The metrics' window over ``trace_calls`` calls (the device's
    activity alone), then ``breakdown_calls`` with the host's."""
    from portbench.yardstick.trace import profiled
    tr = st.run.cell.traffic

    def calls(n):
        return lambda: [_call(st) for _ in range(n)]

    trace = profiled(calls(tr["trace_calls"]))
    host = profiled(calls(tr["breakdown_calls"]), host=True)
    dep = st.run.cell.config["deployment"]
    b = len(st.specs)
    n = tr["trace_calls"] + tr["breakdown_calls"]
    counts = {"calls": tr["trace_calls"], "queries": b,
              "peers": dep["peers"], "items_per_peer": dep["items_per_peer"],
              "k": dep["k"], "attempted": n * b, "failed": 0}
    return trace, host, counts


def release(st: State) -> None:
    st.engine = None
    st.views = None


def check(st: State) -> list:
    """Every answer of every kept call against the reference's top-k of
    its pool row: the number of answers whose values or indices differ."""
    import torch
    k = st.run.cell.config["deployment"]["k"]
    ref_v, ref_i = topk_rows(st.pool, k)
    st.pool = None
    wrong = 0
    sels = [torch.as_tensor(s, device=ref_v.device) for s in st.selections]
    for s, vals, idx in st.answers:
        bad = (torch.stack(vals).to(ref_v.device) != ref_v[sels[s]]) | \
            (torch.stack(idx).to(ref_v.device).long() != ref_i[sels[s]])
        wrong = wrong + bad.any(dim=-1).sum()
    wrong = int(wrong)
    st.run.log(f"{len(st.answers)} of {st.calls} calls checked")
    limits = st.run.cell.limits
    return [("wrong_answers", wrong, limits["wrong_answers"])]
