#!/usr/bin/env python3
"""Where one stacked request of the port's device path spends its time.

    python3 tools/device_path_breakdown.py [--out FILE]

Runs the port's ``DeviceEngine`` on a CUDA device at the size of
``chip_smoke.py`` phase 5 (``make_mesh((64,), ("model",))``, 32 queries
of N = 64 x 20,000 f32 scores, k = 20, a (N, 16) f32 row table) and,
for each schedule of ``fd-dynamic`` (the 32 stacked requests of
``run_many``, and the row gather) and for ``cn`` / ``cn-star``, reports:

  * ``run_s`` of a warm call (median of 5; host wall around the call,
    which ends in a device synchronise);
  * from ``torch.profiler`` over one warm call: the summed device time
    of every kernel and copy, by name, the launch count, and the
    device's idle share of the call's wall time.

Prints one JSON object as its last line (and writes it to ``--out``).
Needs a CUDA device; exits 1 without one.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

PEERS, LOCAL, K, D, B = 64, 20_000, 20, 16, 32


def _profile(fn):
    """(wall seconds, device ops by name) of one call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            ops[ev.key[:120]] = {"device_ms": dev_us / 1e3,
                                 "count": ev.count}
    return wall, dict(sorted(ops.items(), key=lambda kv: -kv[1]["device_ms"]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("device_path_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import DeviceEngine, make_mesh
    from repro_torch.engine import QuerySpec

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n = PEERS * LOCAL
    scores = torch.randn((B, n), generator=gen, device="cuda")
    rows = torch.randn((n, D), generator=gen, device="cuda")
    mesh = make_mesh((PEERS,), ("model",))
    spec = QuerySpec(k=K)
    reqs = list(scores)
    calls = {}
    for sch in ("halving", "doubling", "ring"):
        eng = DeviceEngine(mesh, schedule=sch)
        calls[f"fd-dynamic/{sch}/run_many"] = (
            lambda e=eng: e.run_many([spec] * B, "fd-dynamic", scores=reqs))
        calls[f"fd-dynamic/{sch}/gather"] = (
            lambda e=eng: e.run(spec, "fd-dynamic", scores=scores,
                                rows=rows))
    eng = DeviceEngine(mesh)
    for pol in ("cn", "cn-star"):
        calls[f"{pol}/run_many"] = (
            lambda p=pol: eng.run_many([spec] * B, p, scores=reqs))
    out = {}
    for name, fn in calls.items():
        fn()                                       # build the plan, warm
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        prof_wall, ops = _profile(fn)
        busy = sum(v["device_ms"] for v in ops.values()) / 1e3
        out[name] = {"run_s": statistics.median(walls),
                     "profiled_wall_s": prof_wall, "device_busy_s": busy,
                     "device_idle_share": 1.0 - busy / prof_wall,
                     "launches": sum(v["count"] for v in ops.values()),
                     "device_ops_by_time": ops}
        print(f"[breakdown] {name}: run_s {out[name]['run_s']}, idle share "
              f"{out[name]['device_idle_share']}")
    res = {"card": card, "peers": PEERS, "n": n, "queries": B, "k": K,
           "row_width": D, "calls": out}
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
