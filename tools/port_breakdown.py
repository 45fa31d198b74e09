#!/usr/bin/env python3
"""Where one fused request of the port's main path spends its time.

    python3 tools/port_breakdown.py [--entries 32] [--lifetime S]
                                    [--out FILE]

Runs the port's ``SimEngine`` on a CUDA device over the 100,000-peer
Barabási–Albert overlay of ``chip_smoke.py`` (m=2, seed 7,
``SimParams(seed=5)``), one ``fd-dynamic`` spec of ``--entries``
independent-stream entries at origin 0 (the fused batch of 32 that
``QueryServer.warm(batch_sizes=(1, 32))`` makes), without churn or, with
``--lifetime``, under churn of that mean peer lifetime in seconds (the
§4.2 reroute fold included), and reports:

  * the wall time of ``engine.run`` on a warm engine (median of 3);
  * the same request cut into its phases, each timed alone with the
    device synchronised: the numpy draws (``_precompute_draws``), the
    host-to-device upload of the draws, the device sweep
    (``_fd_sweep``), and the device-to-host copy of the level outputs;
    the rest of the wall time is the numpy epilogue and bookkeeping;
  * from ``torch.profiler`` over one warm ``engine.run``: the summed
    device time of every kernel and copy, by name, and the device's
    idle share of the run's wall time.

Prints one JSON object as its last line (and writes it to ``--out``).
Needs a CUDA device; exits 1 without one.
"""
import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _wall(fn, reps=3):
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--entries", type=int, default=32)
    ap.add_argument("--lifetime", type=float, default=math.inf)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("port_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.engine import QuerySpec, SimEngine, get_policy
    from repro_torch.engine.sim_torch import (_device_slices, _fd_sweep,
                                              _to_device)
    from repro_torch.p2psim import SimParams, barabasi_albert
    from repro_torch.p2psim.simulate import _precompute_draws, wait_time

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda")
    E = args.entries
    churn = not math.isinf(args.lifetime)
    pol = get_policy("fd-dynamic").variant(lifetime_mean_s=args.lifetime)
    p = SimParams(seed=5)
    engine = SimEngine(barabasi_albert(100_000, m=2, seed=7), p)
    spec = QuerySpec(origins=(0,) * E, rng="independent")
    engine.run(spec, pol)                          # build + warm
    run_s = _wall(lambda: engine.run(spec, pol))

    sts, _ = engine.plan.origin_statics(np.zeros(1, np.int64), p.ttl,
                                        "st1+2")
    st = sts[0]
    sl = engine.plan.depth_slices(st, reroute=churn)
    levels, els, rr = _device_slices(sl, dev)
    seeds = p.seed + np.arange(E, dtype=np.int64)
    origin = np.zeros(E, np.int64)
    n = engine.plan.top.n

    def draw():
        return _precompute_draws(origin, seeds, n, p, "fd", "st1+2",
                                 args.lifetime, True)

    draws_s = _wall(draw)
    dr = draw()
    host = (dr.scores, dr.t_exec, dr.up_term, dr.dn_term, dr.lam)
    if churn:
        host += (dr.death,)

    def upload():
        return [_to_device(a, dev) for a in host]

    upload_s = _wall(upload)
    scores, t_exec, up, dn, lam, *death = upload()
    wt = _to_device(wait_time(st.ttl_rem, p), dev)
    tqf = _to_device(np.where(st.depth >= 0, st.depth * p.t_qsnd_s,
                              np.inf), dev)

    def sweep():
        return _fd_sweep(scores, t_exec, up, dn, wt, tqf, lam, levels, els,
                         k=p.k, with_st1=True,
                         death=death[0] if churn else None,
                         rr=rr if churn else None)

    sweep_s = _wall(sweep)
    out = sweep()

    def download():
        for d in range(len(out[0])):
            out[0][d].cpu().numpy()
            out[1][d].cpu().numpy()
            out[2][d].cpu().numpy()
            if churn:
                out[4][d].cpu().numpy()

    download_s = _wall(download)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run(spec, pol)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # device-side events only (kernels and copies): a host op's device
    # time is the sum of the device events it launched, counted already
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            kernels[ev.key[:120]] = {"device_ms": dev_us / 1e3,
                                     "count": ev.count}
    busy_ms = sum(v["device_ms"] for v in kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["device_ms"]))
    res = {
        "card": card, "n_peers": n, "entries": E, "k": p.k,
        "policy": "fd-dynamic",
        "lifetime_mean_s": args.lifetime if churn else None,
        "run_s": run_s,
        "phases_s": {"draws": draws_s, "upload": upload_s,
                     "sweep": sweep_s, "download": download_s,
                     "epilogue_and_rest": run_s - draws_s - upload_s
                     - sweep_s - download_s},
        "profiled_run_s": prof_wall, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / 1e3 / prof_wall,
        "device_ops_by_time": top,
    }
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
