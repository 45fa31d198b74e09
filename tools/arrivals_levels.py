#!/usr/bin/env python3
"""The arrivals kernel level by level, cold and on the path's warm flood.

    python3 tools/arrivals_levels.py [--old FILE] [--reps 20] [--out FILE]

Builds the level shapes of ``chip_smoke.py`` (origin 0 of the
100,000-peer Barabási–Albert overlay, m=2, seed 7, ``SimParams(seed=5)``,
E = 32 independent-stream entries, f64, int32 parent positions) and, on a
CUDA device, times each design of the kernel at every level:

  * ``plan``: the port's ``arrivals_cuda`` as its plan launches it;
  * ``gathered``: the same kernel made to gather every level's parents
    from L2 (``arrivals_plan(..., staged=False)``);
  * ``staged``: made to stage the parent level in shared memory at
    every level where it fits (``staged=True``), and as planned where it
    does not;
  * ``old``, with ``--old FILE``: the arrivals kernel of another
    ``sweep.cu`` whose launcher is ``repro_arrivals_f64_i32(tq_prev, dn,
    par_pos, out, E, L, Lp, stream)``, e.g. a parent commit's source from
    ``git show <rev>:src/repro_torch/kernels/csrc/sweep.cu``, compiled
    here by ``nvcc`` into ``build/arrivals_old/``.

Two kinds of input: ``cold``, independent random tensors a level (as
``chip_smoke.py`` phase 6 times them), and ``warm``, the path's forward
flood as ``engine/sim_torch.py::_arrivals`` runs it on the request's own
draws, where each level reads the level just written and the ``dn``
columns just gathered.  Every design is first held bit-equal to
``arrivals_ref`` at every level, cold and warm (its output's memory
filled with NaN first).  Then each level's device time per launch (the
mean over ``--reps`` sweeps in one ``torch.profiler`` window) beside its
bytes bound: the distinct parents each row reads, ``dn`` read, ``out``
written and ``par_pos`` over 3.35 TB/s (``bound_ms``); also with the
whole parent level counted as read (``bound_ms_whole_parent_level``,
the formula of PR 14's kernel table), and the device time of a launch
of one output element (``one_element_ms``, the least a launch takes).
Prints one JSON object as its
last line (and writes it to ``--out``).  Needs a CUDA device; exits 1
without one.
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

MEM_BYTES_PER_S = 3.35e12
E = 32
_P, _LL = ctypes.c_void_p, ctypes.c_longlong


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _path(dev):
    """The path's device levels of origin 0 and the request's ``dn_term``
    (E, n) on the card."""
    import numpy as np
    from repro_torch.engine import SimEngine
    from repro_torch.engine.sim_torch import _device_slices, _to_device
    from repro_torch.p2psim import SimParams, barabasi_albert
    from repro_torch.p2psim.simulate import _precompute_draws
    top = barabasi_albert(100_000, m=2, seed=7)
    p = SimParams(seed=5)
    eng = SimEngine(top, p, device="cpu")
    sts, _ = eng.plan.origin_statics([0], p.ttl, "st1+2")
    levels, _, _ = _device_slices(eng.plan.depth_slices(sts[0]), dev)
    dr = _precompute_draws(np.zeros(E, np.int64),
                           p.seed + np.arange(E, dtype=np.int64), top.n, p,
                           "fd", "st1+2", float("inf"), True)
    return levels, _to_device(dr.dn_term, dev)


def _nbytes(t):
    return t.numel() * t.element_size()


def _bounds(tq, dn, pp):
    """Bytes bounds (ms) of one level: ``bound_ms`` counts the distinct
    parents each row reads, ``bound_ms_sectors`` the 32-byte sectors
    they lie in (the card's least read), ``bound_ms_whole_parent_level``
    the whole of tq_prev."""
    import torch
    E, Lp = tq.shape
    size = tq.element_size()
    par = pp.unique().long()
    rows = torch.arange(E, device=pp.device)[:, None] * Lp
    sectors = int(((rows + par[None, :]) * size // 32).unique().numel())
    rest = 2 * _nbytes(dn) + _nbytes(pp)
    ms = 1e3 / MEM_BYTES_PER_S
    return {"bound_ms": (par.numel() * E * size + rest) * ms,
            "bound_ms_sectors": (sectors * 32 + rest) * ms,
            "bound_ms_whole_parent_level": (_nbytes(tq) + rest) * ms}


def _same_into_nan(fn, args, ref):
    """``fn(*args, out=...)`` into an output filled with NaN (so a
    skipped element shows) equals ``ref`` bit for bit."""
    import torch
    got = fn(*args, out=torch.full_like(args[1], float("nan")))
    return torch.equal(got.view(torch.int64), ref.view(torch.int64))


def _per_launch_ms(fn, n_launch, reps):
    """Device ms of each of the ``n_launch`` arrivals kernels one call of
    ``fn`` launches, in launch order, each the mean over ``reps`` calls in
    one profiler window; None where the profiler missed some."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ks = sorted((ev.time_range.start, ev.time_range.elapsed_us())
                for ev in prof.events()
                if ev.device_type == DeviceType.CUDA
                and "arrivals_kernel" in ev.name)
    if len(ks) != n_launch * reps:
        return None
    return [statistics.fmean(us for _, us in ks[i::n_launch]) / 1e3
            for i in range(n_launch)]


def _old_launcher(src):
    """``(tq_prev, dn, par_pos) -> out`` through another sweep.cu's
    arrivals launcher, built here."""
    import torch
    from repro_torch.kernels import _build
    out = ROOT / "build" / "arrivals_old"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libarrivals_old.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).repro_arrivals_f64_i32
    fn.argtypes = [_P] * 4 + [_LL] * 3 + [_P]
    fn.restype = ctypes.c_int

    def call(tq, dn, pp, out=None):
        o = torch.empty_like(dn) if out is None else out
        _build.check(fn(tq.data_ptr(), dn.data_ptr(), pp.data_ptr(),
                        o.data_ptr(), dn.shape[0], dn.shape[1], tq.shape[1],
                        torch.cuda.current_stream().cuda_stream), "old")
        return o
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("arrivals_levels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.sweep import arrivals_ref
    from repro_torch.kernels.sweep.sweep import (SMEM_MAX, _arrivals,
                                                 arrivals_plan)
    dev = torch.device("cuda")
    card = _card()
    _build.ensure_built()
    levels, dn_term = _path(dev)
    designs = {"plan": lambda *c, out=None: _arrivals(*c, None, out),
               "gathered": lambda *c, out=None: _arrivals(*c, False, out),
               "staged": lambda *c, out=None: _arrivals(
                   *c, True if _nbytes(c[0][0]) <= SMEM_MAX else None, out)}
    if args.old:
        designs["old"] = _old_launcher(args.old)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cold = []
    for d in range(1, len(levels)):
        pp = levels[d]["par_pos"]
        Lp = levels[d - 1]["vv"].shape[0]
        cold.append(tuple(torch.rand(shape, generator=gen, device=dev,
                                     dtype=torch.float64)
                          for shape in ((E, Lp), (E, pp.shape[0])))
                    + (pp,))

    def flood(fn):
        """The forward flood of ``_arrivals``, level d from level d-1."""
        t = [torch.zeros((E, 1), dtype=torch.float64, device=dev)]
        for lv in levels[1:]:
            t.append(fn(t[-1], dn_term[:, lv["vv"]], lv["par_pos"]))
        return t

    warm = flood(arrivals_ref)
    warm_calls = [(warm[d - 1], dn_term[:, lv["vv"]], lv["par_pos"])
                  for d, lv in enumerate(levels) if d > 0]
    for name, fn in designs.items():
        for kind, calls in (("cold", cold), ("warm", warm_calls)):
            for i, c in enumerate(calls):
                if not _same_into_nan(fn, c, arrivals_ref(*c)):
                    raise SystemExit(f"arrivals {name} {kind} level "
                                     f"{i + 1}: != plain version")
    rows = []
    for tq, dn, pp in cold:
        rows.append({"L": dn.shape[1], "L_prev": tq.shape[1],
                     "distinct_parents": int(pp.unique().numel()),
                     **_bounds(tq, dn, pp),
                     "plan": arrivals_plan(E, dn.shape[1], tq.shape[1],
                                           8)._asdict(),
                     "cold_device_ms": {}, "warm_device_ms": {}})
    print(f"[levels] {[(r['L'], r['L_prev']) for r in rows]}, E={E}, f64: "
          f"{', '.join(designs)} bit-equal to arrivals_ref, cold and warm")
    n = len(rows)
    # one output element: the least a launch takes on the device
    one = (torch.ones((1, 1), dtype=torch.float64, device=dev),
           torch.ones((1, 1), dtype=torch.float64, device=dev),
           torch.zeros(1, dtype=torch.int32, device=dev))
    sweeps = {}
    for name, fn in designs.items():
        c = _per_launch_ms(lambda: [fn(*x) for x in cold], n, args.reps)
        w = _per_launch_ms(lambda: flood(fn), n, args.reps)
        f = _per_launch_ms(lambda: fn(*one), 1, args.reps)
        for i, r in enumerate(rows):
            r["cold_device_ms"][name] = None if c is None else c[i]
            r["warm_device_ms"][name] = None if w is None else w[i]
        sweeps[name] = {"cold_device_ms": None if c is None else sum(c),
                        "warm_device_ms": None if w is None else sum(w),
                        "one_element_ms": None if f is None else f[0]}
    bound = sum(r["bound_ms"] for r in rows)
    for i, r in enumerate(rows):
        print(f"[level {i + 1}] " + json.dumps(r))
    print("[sweep] " + json.dumps(sweeps) + f" bound {bound} ms")
    print(card)
    res = {"card": card, "E": E, "dtype": "float64", "reps": args.reps,
           "bound_ms": bound,
           "bound_ms_sectors": sum(r["bound_ms_sectors"] for r in rows),
           "bound_ms_whole_parent_level": sum(
               r["bound_ms_whole_parent_level"] for r in rows),
           "levels": rows, "sweep": sweeps, "old_source": args.old}
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
