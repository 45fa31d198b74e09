#!/usr/bin/env python3
"""The merge kernel at every launch of a sweep, by route and against a
parent commit's kernel.

    python3 tools/merge_levels.py [--old FILE] [--reps 20] [--out FILE]

Builds the merges of ``chip_smoke.py`` phase 6 (origin 0 of the
100,000-peer Barabási–Albert overlay, m=2, seed 7, ``SimParams(seed=5)``,
E = 32 independent-stream entries, K = 32): the static fold's rounds
(masked) and each level's parent merge (unmasked), 50 launches a sweep,
each an (E, P, K) pair of random descending lists, in f64, f32 and bf16;
and the device path's merges, f32, k = 20, unmasked: (32, 20) and the
32 stacked queries of 64 peers, (32, 64, 20).  On a CUDA device it times
each design of the kernel at every launch:

  * ``plan``: the port's ``merge_cuda`` as its plan launches it;
  * ``bulk``: made to take the TMA ring (``route=BULK``) at every launch
    it can take (k = 32), else as planned;
  * ``direct``: made to take the direct route (``route=DIRECT``: a warp
    a row pair for 16 < k <= 32 from ``WARP_MIN_ROWS`` rows, else one
    thread an element);
  * ``old``, with ``--old FILE``: the merge kernel of another
    ``merge.cu`` whose launchers are ``repro_merge_{f64,f32,bf16}(va, ia,
    vb, ib, ma, mb, vo, io, rows, k, stream)``, e.g. the parent commit's
    source from ``git show 454ab0a:src/repro_torch/kernels/csrc/merge.cu
    > build/merge_parent.cu``, compiled here by ``nvcc`` into
    ``build/merge_old/``.

Every design is first held bit-equal to ``merge_ref`` at every launch,
into outputs filled with NaN.  Then each launch's device time (the mean
over ``--reps`` sweeps in one ``torch.profiler`` window; two windows a
design, taken in turns, each design then each in reverse order, and
the lower of the two) beside its bytes bound: both lists' values and owners read once, the masks, the
merged list written once, over 3.35 TB/s.  The sweep's launches are
summed by size class of P (``P <= 200``, ``200 < P < 4000``,
``P >= 4000``).  Also the device time of a launch of one row pair
(``one_row_ms``, the least a launch takes).  Prints one JSON object as
its last line without the per-launch rows (all of it to ``--out``).
Needs a CUDA device; exits 1 without one.
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
K = 32
DEV_K = 20
CLASSES = (("P<=200", 0, 200), ("200<P<4000", 201, 3999),
           ("P>=4000", 4000, 1 << 62))
_P, _LL = ctypes.c_void_p, ctypes.c_longlong


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _pairs():
    """(P, masked) of each merge of one static sweep of origin 0, in
    launch order: each level's fold rounds, then its parent merge."""
    from repro_torch.engine import SimEngine
    from repro_torch.engine.sim_torch import _device_slices
    from repro_torch.p2psim import SimParams, barabasi_albert
    import torch
    top = barabasi_albert(100_000, m=2, seed=7)
    p = SimParams(seed=5)
    eng = SimEngine(top, p, device="cpu")
    sts, _ = eng.plan.origin_statics([0], p.ttl, "st1+2")
    levels, _, _ = _device_slices(eng.plan.depth_slices(sts[0]),
                                  torch.device("cpu"))
    pairs = []
    for lv in levels:
        if "cnode" not in lv:
            continue
        pairs += [(mi_a.shape[0], True) for mi_a, _, _ in lv["rounds"]]
        pairs.append((lv["par_sel"].shape[0], False))
    return pairs


def _lists(lead, k, dt, gen, dev):
    """Random descending k-lists (drawn in f64, or f32 for the narrower
    types, then cast) and int32 owners."""
    import torch
    f = torch.float64 if dt == torch.float64 else torch.float32
    v = torch.rand(lead + (k,), generator=gen, device=dev, dtype=f)
    v = v.sort(dim=-1, descending=True).values.to(dt)
    o = torch.randint(0, 1 << 30, lead + (k,), generator=gen, device=dev,
                      dtype=torch.int32)
    return v, o


def _calls(shapes, dt, gen, dev):
    """(va, ia, vb, ib, ma, mb) per launch; ``shapes`` (lead, k, masked)."""
    import torch
    out = []
    for lead, k, masked in shapes:
        va, ia = _lists(lead, k, dt, gen, dev)
        vb, ib = _lists(lead, k, dt, gen, dev)
        ma = mb = None
        if masked:
            ma = torch.rand(lead, generator=gen, device=dev) < 0.9
            mb = torch.rand(lead, generator=gen, device=dev) < 0.9
        out.append((va, ia, vb, ib, ma, mb))
    return out


def _nbytes(t):
    return 0 if t is None else t.numel() * t.element_size()


def _bound_ms(c):
    va, ia, vb, ib, ma, mb = c
    nb = (_nbytes(va) + _nbytes(ia) + _nbytes(vb) + _nbytes(ib)
          + _nbytes(ma) + _nbytes(mb) + _nbytes(va) + _nbytes(ia))
    return nb / MEM_BYTES_PER_S * 1e3


def _old_launcher(src):
    """``(va, ia, vb, ib, ma, mb, out) -> out`` through another
    merge.cu's launchers, built here."""
    import torch
    from repro_torch.kernels import _build
    d = ROOT / "build" / "merge_old"
    d.mkdir(parents=True, exist_ok=True)
    lib = d / "libmerge_old.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True)
    cdll = ctypes.CDLL(str(lib))
    fns = {}
    for dt, sfx in ((torch.float64, "f64"), (torch.float32, "f32"),
                    (torch.bfloat16, "bf16")):
        fn = getattr(cdll, f"repro_merge_{sfx}")
        fn.argtypes = [_P] * 8 + [_LL, ctypes.c_int, _P]
        fn.restype = ctypes.c_int
        fns[dt] = fn

    def call(va, ia, vb, ib, ma, mb, out=None):
        vo, io = out if out is not None else (torch.empty_like(va),
                                              torch.empty_like(ia))
        p = _build.ptr
        _build.check(fns[va.dtype](
            p(va), p(ia), p(vb), p(ib),
            p(None if ma is None else ma.view(torch.uint8)),
            p(None if mb is None else mb.view(torch.uint8)), p(vo), p(io),
            va.numel() // va.shape[-1], va.shape[-1],
            torch.cuda.current_stream().cuda_stream), "old merge")
        return vo, io
    return call


def _designs(old):
    from repro_torch.kernels.merge.merge import (BULK, DIRECT, _merge,
                                                 merge_plan)

    def forced(route):
        def call(va, ia, vb, ib, ma, mb, out=None):
            ptrs = [t.data_ptr() for t in (va, ia, vb, ib)
                    + (() if out is None else tuple(out))]
            try:
                merge_plan(va.numel() // va.shape[-1], va.shape[-1],
                           va.dtype, ptrs, route=route)
            except ValueError:          # the route cannot take this launch
                return _merge(va, ia, vb, ib, ma, mb, None, out)
            return _merge(va, ia, vb, ib, ma, mb, route, out)
        return call

    d = {"plan": lambda va, ia, vb, ib, ma, mb, out=None:
         _merge(va, ia, vb, ib, ma, mb, None, out),
         "bulk": forced(BULK), "direct": forced(DIRECT)}
    if old:
        d["old"] = _old_launcher(old)
    return d


def _check(name, fn, calls, what):
    """``fn`` into NaN-filled outputs equals ``merge_ref`` bit for bit."""
    import torch
    from repro_torch.kernels.merge import merge_ref
    for n, (va, ia, vb, ib, ma, mb) in enumerate(calls):
        rv, ri = merge_ref(va, ia, vb, ib, valid_a=ma, valid_b=mb)
        out = (torch.full_like(rv, float("nan")), torch.full_like(ri, -7))
        gv, gi = fn(va, ia, vb, ib, ma, mb, out=out)
        bits = {8: torch.int64, 4: torch.int32, 2: torch.int16}[
            rv.element_size()]
        if not (torch.equal(gv.view(bits), rv.view(bits))
                and torch.equal(gi, ri)):
            raise SystemExit(f"merge {name} {what} launch {n} "
                             f"{tuple(va.shape)}: != merge_ref")


def _per_launch_ms(fn, n_launch, reps, tries=3):
    """Device ms of each of the ``n_launch`` merge kernels one call of
    ``fn`` launches, in launch order, each the mean over ``reps`` calls
    in one profiler window; a window in which the profiler missed some
    launches is taken again, up to ``tries`` windows, then None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ks = sorted((ev.time_range.start, ev.time_range.elapsed_us())
                    for ev in prof.events()
                    if ev.device_type == DeviceType.CUDA
                    and "merge_kernel" in ev.name)
        if len(ks) == n_launch * reps:
            return [statistics.fmean(us for _, us in ks[i::n_launch]) / 1e3
                    for i in range(n_launch)]
    return None


def _in_turns(designs, measure):
    """``measure(fn)`` of every design, in turns (each design, then each
    in reverse order), launch by launch the lower of its two: device
    times drift between profiler windows, by up to a few percent on the
    launches that take a few microseconds."""
    names = list(designs)
    got = {name: [] for name in names}
    for name in names + names[::-1]:
        got[name].append(measure(designs[name]))
    return {name: None if any(r is None for r in rs)
            else [min(x) for x in zip(*rs)] for name, rs in got.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("merge_levels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.merge.merge import ROUTES, merge_plan
    dev = torch.device("cuda")
    card = _card()
    _build.ensure_built()
    designs = _designs(args.old)
    pairs = _pairs()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    res = {"card": card, "E": E, "K": K, "reps": args.reps,
           "old_source": args.old, "P": [P for P, _ in pairs],
           "masked": [m for _, m in pairs], "dtypes": {}}
    print(f"[sweep] {len(pairs)} merges a sweep, P = {res['P']}")
    cases = {str(dt).split(".")[-1]: (dt, [((E, P), K, m) for P, m in pairs])
             for dt in (torch.float64, torch.float32, torch.bfloat16)}
    cases["device_f32"] = (torch.float32, [((32,), DEV_K, False),
                                           ((32, 64), DEV_K, False)])
    for tag, (dt, shapes) in cases.items():
        calls = _calls(shapes, dt, gen, dev)
        for name, fn in designs.items():
            _check(name, fn, calls, tag)
        n = len(calls)
        per = _in_turns(designs, lambda fn: _per_launch_ms(
            lambda: [fn(*c) for c in calls], n, args.reps))
        bounds = [_bound_ms(c) for c in calls]
        launches = []
        for i, c in enumerate(calls):
            rows = c[0].numel() // c[0].shape[-1]
            plan = merge_plan(rows, c[0].shape[-1], dt,
                              [c[j].data_ptr() for j in range(4)])
            launches.append({
                "shape": list(c[0].shape), "masked": c[4] is not None,
                "route": ROUTES[plan.route], "plan": plan._asdict(),
                "bound_ms": bounds[i],
                "device_ms": {k: None if v is None else v[i]
                              for k, v in per.items()}})
        out = {"bound_ms": sum(bounds), "launches": launches,
               "device_ms": {k: None if v is None else sum(v)
                             for k, v in per.items()}}
        out["share"] = {k: None if v is None else out["bound_ms"] / v
                        for k, v in out["device_ms"].items()}
        if tag != "device_f32":
            out["classes"] = {}
            for cname, lo, hi in CLASSES:
                idx = [i for i, (P, _) in enumerate(pairs) if lo <= P <= hi]
                out["classes"][cname] = {
                    "launches": len(idx),
                    "bound_ms": sum(bounds[i] for i in idx),
                    "device_ms": {k: None if v is None
                                  else sum(v[i] for i in idx)
                                  for k, v in per.items()}}
        # one row pair: the least a launch takes
        one = _calls([((1,), K, False)], dt, gen, dev)
        out["one_row_ms"] = {
            name: None if f is None else f[0] for name, f in _in_turns(
                designs, lambda fn: _per_launch_ms(lambda: fn(*one[0]), 1,
                                                   args.reps)).items()}
        res["dtypes"][tag] = out
        summary = {k: v for k, v in out.items() if k != "launches"}
        print(f"[{tag}] " + json.dumps(summary))
        del calls
        torch.cuda.empty_cache()
    print(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res) + "\n")
    for out in res["dtypes"].values():
        del out["launches"]
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
