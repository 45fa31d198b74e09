#!/usr/bin/env python3
"""Both wait kernels level by level, cold and on the path's warm sweep.

    python3 tools/wait_levels.py [--old [NAME=]FILE ...] [--reps 20]
                                 [--runs 3] [--out FILE]

Builds the level shapes of ``chip_smoke.py`` phase 3 (origin 0 of the
100,000-peer Barabási–Albert overlay, m=2, seed 7, ``SimParams(seed=5)``,
E = 32 independent-stream entries) and, on a CUDA device, times the wait
kernel and its churn variant at every level in f64, f32 and bf16, each
design in turn:

  * ``plan``: the port's ``wait_cuda`` as ``wait_plan`` launches it;
  * ``scalar`` and ``vector``: the same kernel made to take one route at
    every level (``wait_plan(..., vector=False / True)``);
  * ``NAME`` (``old`` where no name is given), for each ``--old
    [NAME=]FILE``: the wait kernels of another ``sweep.cu``, compiled
    here by ``nvcc`` into ``build/wait_NAME/``.  A source that exports
    ``repro_wait_plan`` is launched as its own plan says, through
    launchers of this tree's arguments (``repro_wait_<dt>(own, all_in,
    deadline, s_out, total, vec, grid, stream)``); one that does not,
    through the first design's ``repro_wait_<dt>(own, all_in, deadline,
    s_out, total, stream)`` and ``repro_wait_churn_<dt>(own, all_in,
    deadline, death, s_out, send_out, total, stream)``, e.g. a parent's
    source from ``git show <rev>:src/repro_torch/kernels/csrc/sweep.cu``.

Two kinds of input: ``cold``, independent U[0, 1) tensors a level (death
times 1.5 U[0, 1), about a third dead) as ``chip_smoke.py`` phase 6
times them, with a 128 MB write between sweeps so that no operand is
left in L2; and ``warm``, the path's own operands as
``engine/sim_torch.py::_fd_sweep`` computes them from the request's
draws just before each wait (its adds and gathers, so in L2), the churn
variant under churn at a mean lifetime of 60 s with the §4.2 reroute.
Every design is first held bit-equal to ``wait_ref`` at every level,
cold (into outputs filled with NaN) and warm (every level's send times
and merged lists of a whole sweep).  Then each level's device time per
launch (the mean over ``--reps`` cold sweeps, or half as many warm
ones, in one ``torch.profiler`` window that runs the designs in turn;
each launch is joined to its design and level through a
``record_function`` tag and its correlation id in the exported trace;
``--runs`` such windows, the designs in forward order in one and
reversed in the next, each window's mean kept with the min and max
across windows, the mean of the windows reported) beside its bytes
bound (4 arrays of the level for the wait, 6
for the churn variant, over 3.35 TB/s) and the share, the sweep's sums,
and the device time of a launch of one element (``one_element_ms``, the
least a launch takes).  Prints one JSON object as its last line (and
writes it to ``--out``).  Needs a CUDA device; exits 1 without one.
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
E = 32
LIFETIME_S = 60.0
_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_SFX = {"float64": "f64", "float32": "f32", "bfloat16": "bf16"}


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _same(a, b):
    import torch
    bits = {8: torch.int64, 4: torch.int32, 2: torch.int16}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(bits), b.view(bits))


def _old_launchers(name, src):
    """``(own, all_in, deadline, death=None, out=None)`` through another
    sweep.cu's wait launchers, built here."""
    import torch
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / f"wait_{name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libwait_{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    planned = hasattr(lib, "repro_wait_plan")
    if planned:
        lib.repro_wait_plan.argtypes = [_LL] + [ctypes.c_int] * 4 + [_P]
        lib.repro_wait_plan.restype = ctypes.c_int

    def plan_args(ins, outs):
        """(vec, grid) of the source's own plan for these operands."""
        buf = (_LL * 3)()
        aligned = all(t.data_ptr() % 16 == 0 for t in ins + outs)
        _build.check(lib.repro_wait_plan(ins[0].numel(),
                                         ins[0].element_size(), len(ins),
                                         int(aligned), -1,
                                         ctypes.cast(buf, _P)),
                     f"{name} wait plan")
        return [buf[0], buf[2]]

    def call(own, all_in, dl, death=None, out=None):
        sfx = _SFX[str(own.dtype).split(".")[-1]]
        st = torch.cuda.current_stream().cuda_stream
        churn = death is not None
        if churn:
            outs = ((torch.empty_like(own), torch.empty_like(own))
                    if out is None else tuple(out))
            ins = (own, all_in, dl, death)
        else:
            outs = (torch.empty_like(own) if out is None else out,)
            ins = (own, all_in, dl)
        ts = ins + outs
        extra = plan_args(ins, outs) if planned else []
        fn = getattr(lib, f"repro_wait{'_churn' if churn else ''}_{sfx}")
        fn.argtypes = [_P] * len(ts) + [_LL] * (1 + len(extra)) + [_P]
        fn.restype = ctypes.c_int
        _build.check(fn(*(t.data_ptr() for t in ts), own.numel(), *extra,
                        st), f"{name} wait")
        return outs if churn else outs[0]
    return call


def _tagged_ms(calls, reps, name):
    """Device ms of the kernels named ``name`` by the tag they were
    launched under (:func:`chip_smoke.kernels_by_tag`: one profiler
    window runs each function of ``calls`` in turn, ``reps`` times; each
    launch to be timed runs inside ``chip_smoke.tagged``).  Returns
    {tag: (mean ms, kernels seen)}."""
    per = kernels_by_tag(calls, reps)
    return {tag: (statistics.fmean(k[name]) / 1e3, len(k[name]))
            for tag, k in per.items() if k.get(name)}


def _windows(calls, reps, name, runs):
    """:func:`_tagged_ms` over ``runs`` profiler windows, ``calls`` in
    forward order in the first window, reversed in the second, and so
    on.  Returns {tag: (mean of the windows' means, kernels seen, each
    window's mean)}."""
    per = {}
    for w in range(runs):
        for tag, (ms, seen) in _tagged_ms(calls[::-1] if w % 2 else calls,
                                          reps, name).items():
            means, n = per.get(tag, ([], 0))
            per[tag] = (means + [ms], n + seen)
    return {tag: (statistics.fmean(means), n, means)
            for tag, (means, n) in per.items()}


def _path(dev):
    """The engine's plan of origin 0 and the request's draws, static
    and under churn (host arrays)."""
    import numpy as np
    from repro_torch.engine import SimEngine
    from repro_torch.p2psim import SimParams, barabasi_albert
    from repro_torch.p2psim.simulate import _precompute_draws, wait_time
    top = barabasi_albert(100_000, m=2, seed=7)
    p = SimParams(seed=5)
    eng = SimEngine(top, p, device="cpu")
    sts, _ = eng.plan.origin_statics([0], p.ttl, "st1+2")
    st = sts[0]
    seeds = p.seed + np.arange(E, dtype=np.int64)
    draws = {life: _precompute_draws(np.zeros(E, np.int64), seeds, top.n,
                                     p, "fd", "st1+2", life, True)
             for life in (float("inf"), LIFETIME_S)}
    return eng.plan, st, p, draws, wait_time(st.ttl_rem, p)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", action="append", default=[],
                    metavar="[NAME=]FILE")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("wait_levels: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch.engine.sim_torch as sim_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.sweep import wait_ref
    from repro_torch.kernels.sweep.sweep import _wait, wait_plan
    dev = torch.device("cuda")
    card = _card()
    _build.ensure_built()
    plan, st, p, draws, wt_host = _path(dev)
    sl = plan.depth_slices(st, reroute=True)
    levels, els, rr = sim_torch._device_slices(sl, dev)
    widths = [int(lv["vv"].shape[0]) for lv in levels]

    def forced(vector):
        return (lambda own, all_in, dl, death=None, out=None:
                _wait(own, all_in, dl, death, vector, out))
    designs = {"plan": forced(None), "scalar": forced(False),
               "vector": forced(True)}
    for spec in args.old:
        name, _, src = spec.rpartition("=")
        name = name or "old"
        if name in designs:
            raise SystemExit(f"wait_levels: design {name} given twice")
        designs[name] = _old_launchers(name, src)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    res = {"card": card, "E": E, "reps": args.reps, "runs": args.runs,
           "levels": widths, "old_sources": args.old, "dtypes": {}}
    for dt in (torch.float64, torch.float32, torch.bfloat16):
        tag = str(dt).split(".")[-1]
        prec = {"float64": "f64", "float32": "f32", "bfloat16": "bf16"}[tag]

        def rnd(L, scale=1.0):
            return (scale * torch.rand((E, L), generator=gen, device=dev,
                                       dtype=torch.float32
                                       if dt == torch.bfloat16 else dt)
                    ).to(dt)
        cold = {"wait": [(rnd(L), rnd(L), rnd(L)) for L in widths],
                "wait_churn": [(rnd(L), rnd(L), rnd(L), rnd(L, 1.5))
                               for L in widths]}

        def up(a):
            return sim_torch._upload(a, prec, dev)
        sweeps = {}
        for variant, life in (("wait", float("inf")),
                              ("wait_churn", LIFETIME_S)):
            dr = draws[life]
            args_sweep = (up(dr.scores), up(dr.t_exec), up(dr.up_term),
                          up(dr.dn_term), up(wt_host),
                          up(np.where(st.depth >= 0,
                                      st.depth * p.t_qsnd_s, np.inf)),
                          up(dr.lam), levels, els)
            kw = {"k": p.k, "with_st1": True}
            if variant == "wait_churn":
                kw.update(death=up(dr.death), rr=rr)
            sweeps[variant] = (args_sweep, kw)

        def warm(variant, design):
            """One _fd_sweep whose waits go through ``design``."""
            a, kw = sweeps[variant]
            orig = sim_torch.wait_propagate
            sim_torch.wait_propagate = (
                lambda o, al, d, *, death=None: design(o, al, d, death))
            try:
                return sim_torch._fd_sweep(*a, **kw)
            finally:
                sim_torch.wait_propagate = orig

        ref_design = (lambda o, a, d, death=None, out=None:
                      wait_ref(o, a, d, death))
        for variant in ("wait", "wait_churn"):
            want = warm(variant, ref_design)
            for name, fn in designs.items():
                for i, c in enumerate(cold[variant]):
                    churn = len(c) == 4
                    out = (tuple(torch.full_like(c[0], float("nan"))
                                 for _ in range(2)) if churn
                           else torch.full_like(c[0], float("nan")))
                    got = fn(*c, out=out)
                    ref = wait_ref(*c)
                    ok = (all(_same(g, r) for g, r in zip(got, ref))
                          if churn else _same(got, ref))
                    if not ok:
                        raise SystemExit(f"{variant} {name} {tag} cold "
                                         f"level {i}: != wait_ref")
                got = warm(variant, fn)
                for j in (0, 1, 2):
                    if not all(_same(g, w) for g, w in zip(got[j], want[j])):
                        raise SystemExit(f"{variant} {name} {tag} warm "
                                         f"sweep: != wait_ref")
        print(f"[{tag}] designs {list(designs)} bit-equal to wait_ref at "
              f"levels {widths}, cold and warm")
        out_dt = {}
        for variant, arrays in (("wait", 4), ("wait_churn", 6)):
            calls = cold[variant]
            rows = [{"L": L, "elements": E * L,
                     "bound_ms": arrays * E * L * calls[0][0].element_size()
                     / MEM_BYTES_PER_S * 1e3,
                     "plan": wait_plan(E * L, calls[0][0].element_size(),
                                       len(calls[0]))._asdict(),
                     "cold_device_ms": {}, "warm_device_ms": {}}
                    for L in widths]
            kname = f"{variant}_kernel"
            one = tuple(torch.ones((1, 1), dtype=dt, device=dev)
                        for _ in range(len(calls[0])))

            def cold_sweep(d, fn):
                flush.zero_()            # nothing of the last sweep in L2
                return [tagged(f"{d}:{i}", fn)(*c)
                        for i, c in enumerate(calls)]

            def warm_sweep(d, fn):
                def by_level(own, all_in, dl, death=None, out=None):
                    i = widths.index(own.shape[1])
                    return tagged(f"{d}:{i}", fn)(own, all_in, dl,
                                                  death, out)
                return warm(variant, by_level)
            timed = {}
            for kind, sweep, reps in (("cold", cold_sweep, args.reps),
                                      ("warm", warm_sweep,
                                       max(args.reps // 2, 1))):
                timed[kind] = _windows(
                    [(lambda d=d, fn=fn: sweep(d, fn))
                     for d, fn in designs.items()], reps, kname, args.runs)
            timed["one"] = _windows(
                [(lambda d=d, fn=fn: tagged(f"{d}:0", fn)(*one))
                 for d, fn in designs.items()], args.reps, kname, args.runs)
            sums = {}
            for name in designs:
                for kind in ("cold", "warm"):
                    for i, r in enumerate(rows):
                        ms, seen, means = timed[kind].get(
                            f"{name}:{i}", (None, 0, []))
                        r[f"{kind}_device_ms"][name] = ms
                        r.setdefault(f"{kind}_windows_ms", {})[name] = means
                        r.setdefault(f"{kind}_kernels_seen", {})[name] = seen
                one_ms = timed["one"].get(f"{name}:0", (None,))[0]
                sums[name] = {"one_element_ms": one_ms}
                for kind in ("cold", "warm"):
                    ms = [r[f"{kind}_device_ms"][name] for r in rows]
                    sums[name][f"{kind}_device_ms"] = (
                        None if None in ms else sum(ms))
            bound = sum(r["bound_ms"] for r in rows)
            for name, v in sums.items():
                for kind in ("cold", "warm"):
                    ms = v[f"{kind}_device_ms"]
                    v[f"{kind}_share"] = None if not ms else bound / ms
            for i, r in enumerate(rows):
                r["cold_share"] = {k: (None if not v else r["bound_ms"] / v)
                                   for k, v in r["cold_device_ms"].items()}
                print(f"[{tag} {variant} level {i}] " + json.dumps(r))
            print(f"[{tag} {variant} sweep] bound {bound} ms "
                  + json.dumps(sums))
            out_dt[variant] = {"bound_ms": bound, "levels": rows,
                               "sweep": sums}
        res["dtypes"][tag] = out_dt
    print(card)
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
