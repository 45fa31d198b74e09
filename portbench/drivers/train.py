"""Training steps of a MoE decoder through the port's training CLI's
builder (``repro_torch.launch.train.build``) and its step function.

The configuration names the port's architecture (``port.arch``) and
holds its sizes; the traffic gives the job: ``seq``, ``batch`` (whole
sequences a step), ``microbatches``, ``remat``, the optimizer's
settings (``optimizer``: the CLI's AdamW with ``lr``, and
``schedule_steps``, from which the builder takes its warm-up), the steps
whose readings are checked (``check_steps``) and the steps under the
profiler (``trace_steps``, ``breakdown_steps``: the two traced windows
of ``--trace 1``).

Set-up builds the step once, copies the benchmark's seeded weights into
the port's parameters, and drives the same object through the checked
steps, on batches 0, 1, ... of the benchmark's token arithmetic
(``yardstick/tokens.py``) fed as the window feeds them.  It reads each
step's loss, the first gradient as AdamW holds it after one step (its
first moment over 1 - b1) and each parameter's change over those steps.
The window goes on from the next batch.  After the window the plain
reference (``reference/moe_lm.py``) trains from the same weights on the
same batches and the readings are compared (:func:`gaps`).
"""
from __future__ import annotations

import dataclasses
import statistics
import time

from portbench.reference import moe_lm
from portbench.yardstick import counts as C
from portbench.yardstick.tokens import batch_at


@dataclasses.dataclass
class State:
    run: object
    spec: object
    opt: object
    params: object
    opt_state: object
    step_fn: object
    next_step: int
    readings: object = None


def _opt(tr: dict) -> moe_lm.Opt:
    o = tr["optimizer"]
    steps = tr["schedule_steps"]
    return moe_lm.Opt(o["lr"], o["b1"], o["b2"], o["eps"],
                      o["weight_decay"], o["grad_clip"],
                      max(steps // 20, 1), steps, o["min_lr_ratio"])


def _batch(run, step: int) -> dict:
    tr, c = run.cell.traffic, run.cell.config["config"]
    return batch_at(run.seed % 2 ** 63, step, batch=tr["batch"],
                    seq=tr["seq"], vocab=c["vocab_size"])


def setup(run) -> State:
    import torch

    from repro_torch.launch.train import build

    tr = run.cell.traffic
    spec = moe_lm.spec_of(run.cell.config)
    opt = _opt(tr)
    st = State(run, spec, opt, None, None, None, 0)
    if run.control:
        return st
    port = run.cell.config["port"]
    run.log("program imported")
    _, _, params, opt_state, step_fn, _ = build(
        port["arch"], smoke=port.get("smoke", False), batch=tr["batch"],
        seq=tr["seq"], model_par=1, microbatches=tr["microbatches"],
        remat=tr["remat"], lr=tr["optimizer"]["lr"],
        steps=tr["schedule_steps"], device=run.device)
    weights = moe_lm.make_weights(spec, run.seed % 2 ** 63, run.device)
    have = {n: (tuple(p.shape), p.dtype)
            for n, p in params.named_parameters()}
    want = {n: (tuple(w.shape), w.dtype) for n, w in weights.items()}
    if have != want:
        raise RuntimeError(
            "the port's parameters differ from the configuration's: "
            f"{sorted(set(have.items()) ^ set(want.items()))[:6]}")
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(weights[n])
    del weights
    run.log("step built, weights copied in")
    st.params, st.opt_state, st.step_fn = params, opt_state, step_fn
    losses, first = [], None
    for _ in range(tr["check_steps"]):
        losses.append(_step(st))
        run.log(f"checked step {len(losses)} done")
        if first is None:
            first = {n: float(torch.linalg.vector_norm(m)) / (1 - opt.b1)
                     for n, m in st.opt_state.m.items()}
    start = moe_lm.make_weights(spec, run.seed % 2 ** 63, run.device)
    deltas = {n: float(torch.linalg.vector_norm(p.detach().float()
                                                - start[n].float()))
              for n, p in params.named_parameters()}
    del start
    st.readings = moe_lm.Readings(losses, first, deltas)
    return st


def _step(st: State) -> float:
    """One step of the window's own call and feed; its loss."""
    from repro_torch.data.pipeline import device_put_batch
    batch = device_put_batch(_batch(st.run, st.next_step), st.run.device)
    st.params, st.opt_state, m = st.step_fn(st.params, st.opt_state, batch)
    st.next_step += 1
    return float(m["loss"])            # waits for the step's kernels


def window(st: State, seconds: float) -> dict:
    import math
    tr = st.run.cell.traffic
    t0 = time.perf_counter()
    steps = failed = 0
    while True:
        failed += not math.isfinite(_step(st))
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    return {"metrics": {"train_tok_s":
                        steps * tr["batch"] * tr["seq"] / elapsed},
            "attempted": steps, "failed": failed}


def traced(st: State):
    """The metrics' window over ``trace_steps`` steps (the device's
    activity alone), then ``breakdown_steps`` with the host's."""
    import math

    import torch

    from portbench.yardstick.trace import profiled
    from repro_torch.kernels import _build
    tr = st.run.cell.traffic
    box = {"failed": 0}

    def steps(n):
        def body():
            for _ in range(n):
                box["failed"] += not math.isfinite(_step(st))
        return body

    before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches = _build.LAUNCHES["topk"]
    trace = profiled(steps(tr["trace_steps"]))
    peak = torch.cuda.max_memory_allocated()
    st.run.log(f"router top-k launches a step "
               f"{(_build.LAUNCHES['topk'] - launches) / tr['trace_steps']}")
    host = profiled(steps(tr["breakdown_steps"]), host=True)
    n = tr["trace_steps"] + tr["breakdown_steps"]
    counts = {"steps": tr["trace_steps"],
              "tokens_per_step": tr["batch"] * tr["seq"],
              "flops_per_token": C.train_flops_per_token(
                  st.run.cell.config["config"], tr["seq"]),
              "peak_window_bytes": peak, "peak_before_bytes": before,
              "attempted": n, "failed": box["failed"]}
    return trace, host, counts


def release(st: State) -> None:
    st.params = st.opt_state = st.step_fn = None


def _reference(run, spec, opt, fp8: bool) -> moe_lm.Readings:
    """The plain reference's readings over the checked steps."""
    import torch
    n = run.cell.traffic["check_steps"]
    batches = [{k: torch.from_numpy(a).to(run.device)
                for k, a in _batch(run, t).items()} for t in range(n)]
    weights = moe_lm.make_weights(spec, run.seed % 2 ** 63, run.device)
    return moe_lm.train(spec, opt, weights, batches, fp8=fp8)


def gaps(prog: moe_lm.Readings, ref: moe_lm.Readings) -> dict:
    """The numbers compared, each a worst case:

    * ``loss_gap``: over the checked steps, |program's loss -
      reference's| / reference's;
    * ``grad_gap``: over the leaves, |norm of the program's first
      gradient - the reference's| / the larger of the reference's norm
      of that leaf and of the median leaf;
    * ``delta_gap``: the same of each leaf's change over the checked
      steps, over the leaves whose reference gradient is at least a
      thousandth of the median leaf's (a leaf with none moves by
      round-off alone).
    """
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog.losses, ref.losses))
    med_g = statistics.median(ref.grad_norms.values())
    grad = max(abs(prog.grad_norms[n] - g) / max(g, med_g)
               for n, g in ref.grad_norms.items())
    kept = [n for n, g in ref.grad_norms.items() if g >= 1e-3 * med_g]
    med_d = statistics.median(ref.delta_norms[n] for n in kept)
    delta = max(abs(prog.delta_norms[n] - ref.delta_norms[n])
                / max(ref.delta_norms[n], med_d) for n in kept)
    return {"loss_gap": loss, "grad_gap": grad, "delta_gap": delta}


def check(st: State) -> list:
    """The program's readings (the control's: the reference in fp8)
    against the reference's, each gap beside the cell's limit."""
    ref = _reference(st.run, st.spec, st.opt, False)
    prog = (_reference(st.run, st.spec, st.opt, True) if st.run.control
            else st.readings)
    med = statistics.median(ref.grad_norms.values())
    kept = sum(g >= 1e-3 * med for g in ref.grad_norms.values())
    st.run.log(f"delta_gap over {kept} of {len(ref.grad_norms)} leaves")
    limits = st.run.cell.limits
    return [(k, v, limits[k]) for k, v in gaps(prog, ref).items()]
