#!/usr/bin/env python3
"""The top-k's select routes (k > 256) launch by launch, beside
``torch.topk`` and other designs.

    python3 tools/topk_select_levels.py [--old [NAME=]FILE ...]
                                        [--shape ROWS,N,K ...]
                                        [--reps 10] [--runs 3] [--out FILE]

Times, on a CUDA device, ``topk_cuda`` at k > 256 (the port's plan:
the resident route of one launch or the long route of three) at the
shapes of ``chip_smoke.py``'s select row, (2048, 20000) k = 512 and
4096 and (32, 1,280,000) k = 1,280, and at the device path's k = 512
shapes of its phase 5 (local execution (256, 20000), CN (4, 1,280,000),
CN* (4, 32768)), or at each ``--shape ROWS,N,K`` instead, each design in
turn:

  * ``plan``: the port's ``topk_cuda``;
  * ``torch.topk``: one PyTorch call for the same values (its tie
    order is its own, so it is a yardstick and is not held to the bits);
  * ``NAME`` (``old`` where no name is given), for each ``--old
    [NAME=]FILE``: the select launchers of another ``topk_select.cu``,
    compiled here by ``nvcc`` into ``build/topk_select_NAME/`` and
    launched by their own exported plan (``repro_topk_select_plan(n, k,
    out)``: out[0] tiles, out[1] int64 scratch words a row) through
    ``repro_topk_select_<dt>(x, rows, n, k, offset, tiles, scratch, vo,
    io, stream)``, e.g. a parent's source from ``git show
    <rev>:src/repro_torch/kernels/csrc/topk_select.cu``.

Two inputs a shape, f32: ``uniform``, U[0, 1) scores, and ``one_value``,
every score 0.5, where a selection by counting collapses into one bin.
Every design but ``torch.topk`` is first held bit-equal to ``topk_ref``
on both.  Then, per shape and input, one ``torch.profiler`` window runs
the designs in turn ``--reps`` times (a 128 MB write between calls,
outside the timed range, so that no score is left in L2); each kernel is joined to its design
through a ``record_function`` tag and its launch's correlation id in the
exported trace.  ``--runs`` such windows, the designs in forward order in
one and reversed in the next; per design the device ms of a call (the
mean of the windows' means, and each window's), its kernels a call by
name with their ms (the per-launch breakdown), the launches a call, and
the share of the bytes bound (each score read once, each value and index
written once, over 3.35 TB/s).  Prints one JSON object as its last line
(and writes it to ``--out``).  Needs a CUDA device; exits 1 without one.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
from chip_smoke import kernels_by_tag, tagged  # noqa: E402

MEM_BYTES_PER_S = 3.35e12
_P, _LL = ctypes.c_void_p, ctypes.c_longlong
#: (what, rows, n, k): chip_smoke.py's select row, then phase 5's k = 512
SHAPES = (("local execution", 2048, 20_000, 512),
          ("local execution", 2048, 20_000, 4096),
          ("CN", 32, 1_280_000, 1_280),
          ("phase 5 local execution", 256, 20_000, 512),
          ("phase 5 CN", 4, 1_280_000, 512),
          ("phase 5 CN*", 4, 32_768, 512))


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _same(a, b):
    import torch
    bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(bits), b.view(bits)))


def _old_design(name, src):
    """``fn(x, k)`` through another topk_select.cu's plan and f32
    launcher, built here."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk.topk import _ARGTYPES
    out_dir = ROOT / "build" / f"topk_select_{name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libtopk_select_{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_topk_select_plan.argtypes = [_LL, ctypes.c_int, _P]
    lib.repro_topk_select_plan.restype = ctypes.c_int
    fn = lib.repro_topk_select_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int

    def call(x, k):
        rows, n = x.shape
        buf = (_LL * 2)()
        _build.check(lib.repro_topk_select_plan(n, k, ctypes.cast(buf, _P)),
                     f"{name} topk select plan")
        tiles, words = buf[0], buf[1]
        scratch = (torch.empty((rows, words), dtype=torch.int64,
                               device=x.device) if words else None)
        vo = torch.empty((rows, k), dtype=torch.float32, device=x.device)
        io = torch.empty((rows, k), dtype=torch.int32, device=x.device)
        _build.check(fn(x.data_ptr(), rows, n, k, 0, tiles,
                        None if scratch is None else scratch.data_ptr(),
                        vo.data_ptr(), io.data_ptr(),
                        torch.cuda.current_stream().cuda_stream),
                     f"{name} topk select")
        return vo, io
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", action="append", default=[],
                    metavar="[NAME=]FILE")
    ap.add_argument("--shape", action="append", default=[],
                    metavar="ROWS,N,K")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("topk_select_levels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk import topk_cuda, topk_ref
    from repro_torch.kernels.topk.topk import plan
    dev = torch.device("cuda")
    card = _card()
    _build.ensure_built()
    designs = {"plan": topk_cuda,
               "torch.topk": lambda x, k: torch.topk(x, k, dim=-1)}
    for spec in args.old:
        name, _, src = spec.rpartition("=")
        name = name or "old"
        if name in designs:
            raise SystemExit(f"topk_select_levels: design {name} given "
                             "twice")
        designs[name] = _old_design(name, src)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    res = {"card": card, "reps": args.reps, "runs": args.runs,
           "old_sources": args.old, "shapes": []}
    shapes = SHAPES
    if args.shape:
        shapes = [("given", *map(int, sp.split(","))) for sp in args.shape]
    for what, rows, n, k in shapes:
        p = plan(n, k)
        bound = (rows * n * 4 + rows * k * 8) / MEM_BYTES_PER_S * 1e3
        for kind in ("uniform", "one_value"):
            x = (torch.rand((rows, n), generator=gen, device=dev)
                 if kind == "uniform"
                 else torch.full((rows, n), 0.5, device=dev))
            want = topk_ref(x, k)
            for name, fn in designs.items():
                if name == "torch.topk":
                    continue
                got = fn(x, k)
                if not (_same(got[0], want[0]) and _same(got[1], want[1])):
                    raise SystemExit(f"{name} at {what} ({rows}, {n}) "
                                     f"k={k} {kind}: != topk_ref")

            # no score of the last call in L2: a write before each call,
            # outside its range
            calls = [lambda name=name, fn=fn: (flush.zero_(),
                                               tagged(name, fn)(x, k))
                     for name, fn in designs.items()]
            windows = [kernels_by_tag(calls[::-1] if w % 2 else calls,
                                      args.reps)
                       for w in range(args.runs)]
            row = {"what": what, "rows": rows, "n": n, "k": k,
                   "input": kind, "route": p.route, "bound_ms": bound,
                   "designs": {}}
            for name in designs:
                means, kernels, launches = [], {}, []
                for per in windows:
                    got = per.get(name, {})
                    means.append(sum(sum(v) for v in got.values())
                                 / args.reps / 1e3)
                    launches.append(sum(len(v) for v in got.values())
                                    / args.reps)
                    for kn, us in got.items():
                        kernels.setdefault(kn, []).append(
                            sum(us) / args.reps / 1e3)
                ms = statistics.fmean(means)
                row["designs"][name] = {
                    "device_ms": ms, "windows_ms": means,
                    "share": bound / ms if ms else None,
                    "launches_per_call": launches,
                    "kernels_ms": {kn: statistics.fmean(v)
                                   for kn, v in kernels.items()}}
            print(f"[{what} ({rows}, {n}) k={k} {kind}] " + json.dumps(row),
                  flush=True)
            res["shapes"].append(row)
            del x, want
    print(card)
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
