#!/usr/bin/env python3
"""Readings of a cell's output check on many seeds in one process: the
program's, the control's (``--control``: the cell's lower precision in
the program's place) or the program's with a fault planted
(``--fault``, ``portbench/faults.py``).  The limits of
``portbench/cells/<cell>.json`` are set from these readings.

    python3 portbench/controls.py --workload fd-query-64 \\
        --seeds 1,2,3 --seconds 3 [--control] [--fault altered]

Each run prints one line ``readings {...}`` with its seed and the
numbers compared; a training cell's control and its runs with a fault
skip the window (``--seconds 0``)."""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
# the interpreter's own cache: where the installed packages' directories
# cannot be written, every process would compile the sources it imports
# anew (seconds of torch); a fixed directory of the checkout keeps them
sys.pycache_prefix = str(_ROOT / "build" / "pycache")
sys.path[0] = str(_ROOT)
sys.path.insert(1, str(_ROOT / "src"))

from portbench import faults, harness  # noqa: E402


def readings(c, seed: int, seconds: float, device: str, *,
             control: bool = False, fault=None) -> dict:
    """One run's result with its seed (the window skipped where
    ``seconds`` is 0: the checked set-up alone)."""
    import torch
    plant = (faults.planted(fault, c.traffic["driver"]) if fault
             else contextlib.nullcontext())
    with plant:
        drv = harness.driver(c)
        t0 = time.perf_counter()
        if seconds > 0:
            res = harness.execute(c, seed, seconds, False, device, t0,
                                  control=control)
        else:
            st = drv.setup(harness.Run(c, seed, device, control))
            drv.release(st)
            gc.collect()
            res = {"checks": {n: {"value": v, "limit": lim}
                              for n, v, lim in drv.check(st)}}
            res["correct"] = all(ch["value"] <= ch["limit"]
                                 for ch in res["checks"].values())
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    res.update(seed=seed, control=control, fault=fault,
               seconds=time.perf_counter() - t0)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/controls.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    for var, path in harness.CACHES.items():
        import os
        os.environ[var] = str(path)
    c = harness.cell(args.workload)
    import torch
    torch.set_num_threads(harness.THREADS)
    for s in args.seeds.split(","):
        res = readings(c, int(s), args.seconds, "cuda",
                       control=args.control, fault=args.fault)
        print("readings " + json.dumps(
            {k: res[k] for k in ("seed", "control", "fault", "correct",
                                 "checks", "seconds")}
            | {k: res[k] for k in ("metrics", "device") if k in res}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
