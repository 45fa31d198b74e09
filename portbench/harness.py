"""The harness: one run of one cell, driven by data.

A cell is an entry of ``workloads`` in ``BENCHMARK.json`` (the root of
the checkout): a configuration and a traffic mix.  The harness finds
everything else by name, and holds no cell's, configuration's or
metric's name itself:

* ``portbench/configs/<config>.json``: the configuration as it is run;
* ``portbench/traffic/<traffic>.json``: the mix's parameters, and the
  ``driver`` that generates it, ``portbench/drivers/<driver>.py``;
* ``portbench/cells/<cell>.json``: the limits of the cell's output
  check;
* ``portbench/metrics/<metric>.py``: the reader of a per-layer metric.

A run: set-up (the driver builds the system under test, makes its
inputs from the seed and warms every shape), then either the measured
window (``--trace 0``: the cell's end-to-end metrics) or a window under
the profiler (``--trace 1``: the per-layer metrics, ``busy_s``,
``window_s`` and a breakdown), then the output check against the plain
reference once the program's state is freed.  The last line of standard
output is one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error and the last key of that object.

A driver module has ``setup(run) -> state``, ``window(state, seconds)
-> {"metrics", "attempted", "failed"}``, ``traced(state) -> (the
metrics' Trace, the breakdown's Trace, counts)``, ``release(state)`` and
``check(state) -> [(name, value, limit)]``; a check passes where each
value is at most its limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
#: top-level modules that may not be loaded in a run: JAX and the JAX
#: package (compared as whole names: the port's name starts with it)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
#: the build and kernel caches, at fixed paths inside the checkout
#: host threads of PyTorch's CPU ops: the work is the card's, and a
#: pool of spinning threads on a shared host only adds noise
THREADS = 2
CACHES = {"TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
          "TRITON_CACHE_DIR": ROOT / "build" / "triton_cache"}


def load_json(*parts: str, root: Path = HERE) -> dict:
    return json.loads(root.joinpath(*parts).read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def cell(name: str, bench: Optional[dict] = None,
         root: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``) with
    its files loaded from ``root``, and the metrics it reports: an
    end-to-end metric
    that lists the cell, or lists no cells; a per-layer metric that
    lists the cell, or lists none and moves an end-to-end metric the
    cell reports."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Cell(name, entry["chips"],
                load_json("configs", f"{entry['config']}.json", root=root),
                load_json("traffic", f"{entry['traffic']}.json", root=root),
                load_json("cells", f"{name}.json", root=root)["limits"],
                e2e, layer)


def driver(c: Cell):
    return importlib.import_module(
        f"portbench.drivers.{c.traffic['driver']}")


def reader(metric: str, root: Path = HERE):
    """The ``read(ctx)`` of ``<root>/metrics/<metric>.py``."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> list:
    """The forbidden top-level modules in ``sys.modules``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell, the seed, the device, and
    ``control``: run the cell's control in the program's place."""
    cell: Cell
    seed: int
    device: str
    control: bool = False
    t0: float = dataclasses.field(default_factory=time.perf_counter)

    def log(self, what: str) -> None:
        """A line on standard error with the seconds since the run's
        start (set-up phases, for the record; never parsed)."""
        print(f"portbench: {time.perf_counter() - self.t0:.3f} s {what}",
              file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def execute(c: Cell, seed: int, seconds: float, trace: bool,
            device: str, t0: float, control: bool = False) -> dict:
    """Set up, measure, check: the result object (without printing)."""
    import torch
    drv = driver(c)
    run = Run(c, seed, device, control, t0)
    state = drv.setup(run)
    setup_s = time.perf_counter() - t0
    run.log("set-up done")
    units = {m["name"]: m["unit"] for m in c.end_to_end + c.per_layer}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device), "count": c.chips}
    metrics, extra, peak_before = {}, {}, 0
    if not trace:
        got = drv.window(state, seconds)
        values = dict(got["metrics"], setup_s=setup_s)
        for m in c.end_to_end:
            if m["name"] not in values:
                raise RuntimeError(f"driver {c.traffic['driver']} "
                                   f"reports no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        from portbench.yardstick import trace as T
        tr, host, got = drv.traced(state)
        busy = T.busy_us(tr.ops) / 1e6
        ctx = {"trace": tr, "counts": got, "cell": c,
               "busy_s": busy, "window_s": tr.window_us / 1e6}
        for m in c.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        dev["busy_s"], dev["window_s"] = busy, tr.window_us / 1e6
        extra["breakdown"] = T.breakdown(host)
        # a traced driver may reset the peak for its window: it then
        # gives the peak before it
        peak_before = got.get("peak_before_bytes", 0)
    dev["memory_peak_bytes"] = 0 if device != "cuda" else max(
        [peak_before] + [torch.cuda.max_memory_allocated(i)
                         for i in range(c.chips)])
    run.log("window closed")
    drv.release(state)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check(state)
    run.log("output checked")
    return {"correct": all(v <= lim for _, v, lim in checks),
            "attempted": got["attempted"], "failed": got["failed"],
            "metrics": metrics, "device": dev, **extra,
            "checks": {n: {"value": v, "limit": lim}
                       for n, v, lim in checks}}


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    for var, path in CACHES.items():
        os.environ[var] = str(path)
    c = cell(args.workload)
    import torch
    torch.set_num_threads(THREADS)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < c.chips:
        print(f"portbench: cell {c.name} needs {c.chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    try:
        result = execute(c, args.seed, args.seconds, bool(args.trace),
                         "cuda", t0)
    except Exception:                   # the run's boundary: no result
        traceback.print_exc()
        return 1
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 3
    print(f"portbench: {c.name} seed {args.seed} on "
          f"{result['device']['kind']} x {c.chips}; {power_limit()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{time.perf_counter() - t0:.3f} s in all", file=sys.stderr)
    for name, chk in result["checks"].items():
        print(f"check {name} = {chk['value']!r} (limit {chk['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
