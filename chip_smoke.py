#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path — the static FD overlay top-k query served
by a ``QueryServer`` — through the hand-written CUDA kernels, and fails
(exit code 1, no result line) when any phase fails:

  1. build the kernel library from ``src/repro_torch/kernels/csrc``;
  2. hold each kernel (merge, arrivals, wait and its churn variant)
     bit-equal to its plain PyTorch version on the card, in f64, f32
     and bf16 (tolerance: exact — ``torch.equal`` on values and owners);
  3. serve 32 independent-stream ``fd-dynamic`` requests from 8 client
     threads plus one ``fd-basic``, ``fd-st1`` and ``fd-st1+2`` request
     on a 100,000-peer Barabási–Albert overlay (the reference package's
     full-size ``jax_backend`` configuration: m=2, seed 7,
     ``SimParams(seed=5)``), and check that every kernel's launch
     counter moved;
  4. run a 4-entry spec on the card and on the port's CPU path and
     require equal bits;
  5. time each kernel at the shapes one sweep of step 3 gives it (CUDA
     events, median of several runs) beside its plain version, one
     PyTorch library call where one computes the same function, and
     its bound (bytes over the card's memory rate).

The line before the last is the ``kernels`` JSON object; the last line
is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate and the float64 non-tensor rate
# (the timed calls run in f64; their compares and adds count against it)
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 34e12
N_PEERS = 100_000
E_MAIN = 32


class PhaseError(RuntimeError):
    """A phase found a fault."""


def _require(cond, msg):
    if not cond:
        raise PhaseError(msg)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps=7, warm=2):
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _max_abs_err(a, b):
    """Largest |a - b| over the positions where the bits differ (0.0
    when equal; inf when a mismatch involves an infinity)."""
    import torch
    if torch.equal(a, b):
        return 0.0
    diff = a.ne(b)
    d = (a[diff].double() - b[diff].double()).abs()
    d = torch.nan_to_num(d, nan=math.inf)
    return float(d.max())


def _sorted_lists(shape, k, dtype, gen, dev, ties=True):
    """Descending (values, owners) k-lists; with ``ties`` the values come
    from a small lattice (many equal scores) and rows get random -inf
    tails, as the sweep's padded lists have."""
    import torch
    if ties:
        v = torch.randint(0, k + 2, shape + (k,), generator=gen,
                          device=dev).to(dtype) / (k + 2)
    else:
        v = torch.rand(shape + (k,), generator=gen, device=dev,
                       dtype=torch.float64).to(dtype)
    v = v.sort(dim=-1, descending=True).values
    if ties:
        n_inf = torch.randint(0, k + 1, shape + (1,), generator=gen,
                              device=dev)
        pos = torch.arange(k, device=dev)
        v = torch.where(pos >= k - n_inf, float("-inf"), v).to(dtype)
    o = torch.randint(0, 1 << 30, shape + (k,), generator=gen, device=dev,
                      dtype=torch.int32)
    return v.contiguous(), o


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _check_merge(gen, dev, errs):
    import torch
    from repro_torch.kernels.merge import merge_cuda, merge_ref
    n = 0
    for k in (1, 7, 20, 32, 64, 256):
        for dt in (torch.float64, torch.float32, torch.bfloat16):
            lead = (3, 37)
            va, ia = _sorted_lists(lead, k, dt, gen, dev)
            vb, ib = _sorted_lists(lead, k, dt, gen, dev)
            ma = torch.rand(lead, generator=gen, device=dev) < 0.7
            mb = torch.rand(lead, generator=gen, device=dev) < 0.7
            for masks in ({}, {"valid_a": ma, "valid_b": mb},
                          {"valid_b": mb}):
                v1, i1 = merge_cuda(va, ia, vb, ib, **masks)
                v2, i2 = merge_ref(va, ia, vb, ib, **masks)
                err = _max_abs_err(v1, v2)
                errs["merge"] = max(errs["merge"], err)
                _require(torch.equal(v1, v2) and torch.equal(i1, i2),
                         f"merge k={k} {dt} masks={sorted(masks)}: kernel "
                         f"!= plain version (max abs err {err})")
                n += 1
    return n


def _check_sweep(levels, gen, dev, errs):
    import torch
    from repro_torch.kernels.sweep import (arrivals_cuda, arrivals_ref,
                                           wait_cuda, wait_ref)
    n = 0
    for dt in (torch.float64, torch.float32, torch.bfloat16):
        for d, lv in enumerate(levels):
            L = lv["vv"].shape[0]
            if d > 0:
                Lp = levels[d - 1]["vv"].shape[0]
                tq = torch.rand((E_MAIN, Lp), generator=gen, device=dev,
                                dtype=torch.float64).to(dt)
                dn = torch.rand((E_MAIN, L), generator=gen, device=dev,
                                dtype=torch.float64).to(dt)
                a1 = arrivals_cuda(tq, dn, lv["par_pos"])
                a2 = arrivals_ref(tq, dn, lv["par_pos"])
                errs["arrivals"] = max(errs["arrivals"],
                                       _max_abs_err(a1, a2))
                _require(torch.equal(a1, a2),
                         f"arrivals level {d} {dt}: kernel != plain")
                n += 1
            own, all_in, dl, death = (
                torch.rand((E_MAIN, L), generator=gen, device=dev,
                           dtype=torch.float64).to(dt) for _ in range(4))
            s1 = wait_cuda(own, all_in, dl)
            s2 = wait_ref(own, all_in, dl)
            errs["wait"] = max(errs["wait"], _max_abs_err(s1, s2))
            _require(torch.equal(s1, s2), f"wait level {d} {dt}: kernel "
                     "!= plain")
            c1, snd1 = wait_cuda(own, all_in, dl, death)
            c2, snd2 = wait_ref(own, all_in, dl, death)
            errs["wait_churn"] = max(errs["wait_churn"],
                                     _max_abs_err(snd1, snd2),
                                     _max_abs_err(c1, c2))
            _require(torch.equal(c1, c2) and torch.equal(snd1, snd2),
                     f"wait (churn variant) level {d} {dt}: kernel != "
                     "plain")
            n += 2
    return n


# ---------------------------------------------------------------------------
# phase 3: the main path through the QueryServer
# ---------------------------------------------------------------------------

def _serve(engine, _build):
    from repro_torch.engine import QueryServer, QuerySpec, ServerConfig
    server = QueryServer(engine, ServerConfig(max_queue=256, max_batch=64))
    pool = (0, 1)
    t0 = time.perf_counter()
    for o in pool:
        server.warm(QuerySpec(origins=(o,), rng="independent"),
                    "fd-dynamic", batch_sizes=(1, E_MAIN))
    for pol in ("fd-basic", "fd-st1", "fd-st1+2"):
        server.warm(QuerySpec(origins=(0,)), pol)
    print(f"[main] warmed in {time.perf_counter() - t0:.3f} s")
    results, errors = [], []
    lock = threading.Lock()

    def client(c):
        try:
            for j in range(4):
                i = 4 * c + j
                h = server.submit(QuerySpec(origins=(pool[i % 2],),
                                            seed=1000 + i,
                                            rng="independent"),
                                  "fd-dynamic")
                res = h.result(timeout=600)
                with lock:
                    results.append(("fd-dynamic", res))
        except Exception as e:           # noqa: BLE001 — reported below
            with lock:
                errors.append(repr(e))

    _build.reset_launches()              # count the main path alone
    t0 = time.perf_counter()
    server.start()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in threads:
        t.start()
    singles = [(pol, server.submit(QuerySpec(origins=(0,), seed=77), pol))
               for pol in ("fd-basic", "fd-st1", "fd-st1+2")]
    for pol, h in singles:
        try:
            results.append((pol, h.result(timeout=600)))
        except Exception as e:           # noqa: BLE001 — reported below
            errors.append(repr(e))
    for t in threads:
        t.join(timeout=900)
    alive = [t for t in threads if t.is_alive()]
    server.stop(drain=not alive, timeout=60)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    m = server.metrics()
    print(f"[main] served {m.served}/{m.submitted} in {wall:.3f} s; "
          f"failed={m.failed} shed={m.shed} timed_out={m.timed_out}")
    print("[main] serving metrics " + json.dumps(m.as_dict()))
    print("[main] launches " + json.dumps(launches))
    _require(not alive, "client threads did not finish")
    _require(not errors, f"requests failed: {errors}")
    _require(m.submitted == 35 and m.served == m.submitted,
             f"served {m.served} of {m.submitted} (expected 35)")
    _require(m.failed == 0, f"{m.failed} requests failed in the engine")
    for pol, res in results:
        _require(res.backend_used == res.backend == "sim-torch",
                 f"{pol}: backend_used={res.backend_used}")
        _require(res.compile_s == 0.0,
                 f"{pol}: live dispatch compiled ({res.compile_s} s)")
        v = res.values
        _require(v.shape == (1, 1, engine.params.k)
                 and bool((v[..., :-1] >= v[..., 1:]).all())
                 and bool((v > 0).all() and (v <= 1).all()),
                 f"{pol}: values not a descending score list: {v}")
        acc = res.metrics.accuracy
        _require(bool(((acc >= 0) & (acc <= 1)).all()),
                 f"{pol}: accuracy out of range {acc}")
    for name in ("merge", "arrivals", "wait"):
        _require(launches[name] > 0, f"kernel {name} never launched on "
                 "the main path")
    return launches, m


# ---------------------------------------------------------------------------
# phase 5: times at main-path shapes
# ---------------------------------------------------------------------------

def _level_calls(levels, dev, gen):
    """One sweep's worth of inputs per kernel, at E=32 and K=32."""
    import torch
    from repro_torch.engine.sim_torch import _next_pow2
    K = _next_pow2(20)
    f64 = torch.float64

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=f64)

    arr, wait, merge = [], [], []
    for d, lv in enumerate(levels):
        L = lv["vv"].shape[0]
        if d > 0:
            Lp = levels[d - 1]["vv"].shape[0]
            arr.append((rnd(E_MAIN, Lp), rnd(E_MAIN, L), lv["par_pos"]))
        wait.append((rnd(E_MAIN, L), rnd(E_MAIN, L), rnd(E_MAIN, L)))
        if "cnode" not in lv:
            continue
        for mi_a, _, _ in lv["rounds"]:
            P = mi_a.shape[0]
            va, ia = _sorted_lists((E_MAIN, P), K, f64, gen, dev, False)
            vb, ib = _sorted_lists((E_MAIN, P), K, f64, gen, dev, False)
            ma = torch.rand((E_MAIN, P), generator=gen, device=dev) < 0.9
            mb = torch.rand((E_MAIN, P), generator=gen, device=dev) < 0.9
            merge.append((va, ia, vb, ib, ma, mb))
        P = lv["par_sel"].shape[0]
        va, ia = _sorted_lists((E_MAIN, P), K, f64, gen, dev, False)
        vb, ib = _sorted_lists((E_MAIN, P), K, f64, gen, dev, False)
        merge.append((va, ia, vb, ib, None, None))
    return arr, wait, merge


def _times(levels, dev, gen, errs, launches):
    import torch
    from repro_torch.kernels.merge import merge_cuda, merge_ref
    from repro_torch.kernels.sweep import (arrivals_cuda, arrivals_ref,
                                           wait_cuda, wait_ref)
    arr, wait, merge = _level_calls(levels, dev, gen)
    # the merge at its main-path shapes is held to its plain version too
    for va, ia, vb, ib, ma, mb in merge:
        v1, i1 = merge_cuda(va, ia, vb, ib, valid_a=ma, valid_b=mb)
        v2, i2 = merge_ref(va, ia, vb, ib, valid_a=ma, valid_b=mb)
        errs["merge"] = max(errs["merge"], _max_abs_err(v1, v2))
        _require(torch.equal(v1, v2) and torch.equal(i1, i2),
                 "merge at main-path shapes: kernel != plain")
    cats = [torch.cat([va, vb], dim=-1) for va, _, vb, _, _, _ in merge]

    def nb(t):
        return t.numel() * t.element_size()

    out = []
    # merge: reads both lists (+ masks) once, writes one list
    m_bytes = sum(nb(va) + nb(ia) + nb(vb) + nb(ib) + nb(va) + nb(ia)
                  + (0 if ma is None else nb(ma) + nb(mb))
                  for va, ia, vb, ib, ma, mb in merge)
    # one binary search of log2(K) + 1 compares per input element
    m_ops = sum(2 * va.numel() * (math.log2(va.shape[-1]) + 1)
                for va, *_ in merge)
    out.append(("merge", "src/repro_torch/kernels/csrc/merge.cu",
                "src/repro/kernels/merge/merge.py:140", len(merge),
                m_bytes, m_ops,
                lambda: [merge_cuda(va, ia, vb, ib, valid_a=ma, valid_b=mb)
                         for va, ia, vb, ib, ma, mb in merge],
                lambda: [merge_ref(va, ia, vb, ib, valid_a=ma, valid_b=mb)
                         for va, ia, vb, ib, ma, mb in merge],
                lambda: [torch.sort(c, dim=-1, descending=True,
                                    stable=True) for c in cats]))
    a_bytes = sum(nb(tq) + 2 * nb(dn) + nb(pp) for tq, dn, pp in arr)
    out.append(("arrivals", "src/repro_torch/kernels/csrc/sweep.cu",
                "src/repro/kernels/sweep/sweep.py:53", len(arr), a_bytes,
                sum(dn.numel() for _, dn, _ in arr),
                lambda: [arrivals_cuda(*c) for c in arr],
                lambda: [arrivals_ref(*c) for c in arr], None))
    w_bytes = sum(4 * nb(o) for o, _, _ in wait)
    out.append(("wait", "src/repro_torch/kernels/csrc/sweep.cu",
                "src/repro/kernels/sweep/sweep.py:98", len(wait), w_bytes,
                sum(4 * o.numel() for o, _, _ in wait),
                lambda: [wait_cuda(*c) for c in wait],
                lambda: [wait_ref(*c) for c in wait], None))
    rows = []
    for (name, source, replaces, calls, nbytes, nops, kern, plain,
         lib) in out:
        # plain, kernel, kernel, plain: take the lower of each pair
        p1 = _cuda_ms(plain)
        k1 = _cuda_ms(kern)
        k2 = _cuda_ms(kern)
        p2 = _cuda_ms(plain)
        t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
        t_ops = nops / OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": min(k1, k2),
            "plain_ms": min(p1, p2), "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if lib is None else _cuda_ms(lib),
            "calls_per_sweep": calls, "bytes_per_sweep": nbytes,
            "shape_note": f"one fd-dynamic sweep of origin 0, E={E_MAIN}"})
    churn = wait[len(wait) // 2]
    death = torch.rand(churn[0].shape, generator=gen, device=dev,
                       dtype=torch.float64)
    wc = _cuda_ms(lambda: wait_cuda(*churn, death))
    wp = _cuda_ms(lambda: wait_ref(*churn, death))
    print(f"[times] wait churn variant at {tuple(churn[0].shape)} f64: "
          f"kernel {wc} ms, plain {wp} ms, bound "
          f"{6 * churn[0].numel() * 8 / MEM_BYTES_PER_S * 1e3} ms")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.engine import QuerySpec, SimEngine
    from repro_torch.engine.sim_torch import _device_slices
    from repro_torch.kernels import _build
    from repro_torch.p2psim import SimParams, barabasi_albert

    dev = torch.device("cuda")
    card = _card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    secs = _build.ensure_built()
    print(f"[build] kernels built and loaded in {secs:.3f} s "
          f"({_build.build_dir()})")

    t0 = time.perf_counter()
    top = barabasi_albert(N_PEERS, m=2, seed=7)
    p = SimParams(seed=5)
    engine = SimEngine(top, p)
    sts, _ = engine.plan.origin_statics([0], p.ttl, "st1+2")
    sl = engine.plan.depth_slices(sts[0])
    levels, _ = _device_slices(sl, dev)
    print(f"[setup] overlay n={top.n} edges={top.n_edges} ttl="
          f"{sts[0].ttl} levels={[len(lv['vv']) for lv in sl.levels]} in "
          f"{time.perf_counter() - t0:.3f} s")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {"merge": 0.0, "arrivals": 0.0, "wait": 0.0, "wait_churn": 0.0}
    n = _check_merge(gen, dev, errs) + _check_sweep(levels, gen, dev, errs)
    torch.cuda.synchronize()
    print(f"[kernels] {n} comparisons bit-equal to the plain versions "
          f"(f64/f32/bf16); max abs err {errs}")

    launches, _ = _serve(engine, _build)

    spec = QuerySpec(origins=(0, 1), n_trials=2, rng="independent")
    t0 = time.perf_counter()
    rg = engine.run(spec, "fd-dynamic")
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc = SimEngine(engine.plan, p, device="cpu").run(spec, "fd-dynamic")
    t_cpu = time.perf_counter() - t0
    import numpy as np
    for f in ("n_reached", "n_edges_pq", "avg_degree", "m_fw", "b_fw",
              "m_bw", "m_rt", "b_bw", "b_rt", "response_time_s",
              "accuracy"):
        _require(np.array_equal(getattr(rg.metrics, f),
                                getattr(rc.metrics, f)),
                 f"card != CPU path on metric {f}")
    _require(np.array_equal(rg.values, rc.values)
             and np.array_equal(rg.indices, rc.indices),
             "card != CPU path on values / indices")
    print(f"[parity] 4-entry spec: card == CPU path bit for bit (card "
          f"{t_card:.3f} s, CPU {t_cpu:.3f} s host wall)")

    rows = _times(levels, dev, gen, errs, launches)
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:                    # noqa: BLE001 — any phase fault
        traceback.print_exc()
        code = 1
    sys.exit(code)
