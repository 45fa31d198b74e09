#!/usr/bin/env python3
"""How far the card's and the CPU path's f32 decode each are from f64.

    python3 tools/decode_xcheck_error.py [--arch qwen2-vl-72b]
        [--layers 1] [--batch 1 --batch 4] [--steps 1] [--window W]
        [--caches] [--out FILE]

Builds ``--arch`` (a decoder-only one) at its full width and
``--layers`` layers in f32 (``--window`` replaces a sliding window's
length) (weights drawn on the card from seed 0, copied to the host, and
widened to f64 there), runs the f32 cross-check of ``chip_smoke.py``
(prefill over a 32-token prompt with the modality stubs' inputs, then
``--steps`` teacher-forced decode steps; TF32 off) on the card, on the
CPU path and on the CPU path in f64, and prints for each batch, for the
prefill's last logits and each step's logits (with ``--caches`` also
every cache tensor after the prefill and after the steps): the largest
and the standard deviation of the card-vs-CPU, card-vs-f64 and
CPU-vs-f64 differences, how many elements fall outside rtol 1e-4 /
atol 1e-5, and the largest |f64| value.  The f64 run keeps the model's
f32 parts (RoPE, ``flash_attention``'s and the decode attention's sums,
the top-k's values); its products, norms and recurrences (``wide``) are
f64.

Prints one JSON object as its last line (and writes it to ``--out``).
Needs a CUDA device; exits 1 without one.
"""
import argparse
import copy
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _stats(a, b, tol):
    d = (a - b).abs()
    return {"max": float(d.max()), "std": float((a - b).std()),
            "outside_tol": int((d > tol["atol"] + tol["rtol"] * b.abs())
                               .sum()), "max_abs_value": float(b.abs().max())}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("decode_xcheck_error: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import state_from_prefill
    from repro_torch.models import model as M

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-vl-72b")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--batch", type=int, action="append")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--caches", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(
        get_config(args.arch), n_layers=args.layers, param_dtype="float32",
        compute_dtype="float32")
    if args.window:
        cfg = dataclasses.replace(cfg, local_window=args.window)
    s_max = cs.DEC_PROMPT + args.steps
    card = M.init_params(torch.Generator(dev).manual_seed(0), cfg,
                         max_seq=s_max, device=dev)
    host = copy.deepcopy(card).to("cpu")
    wide = copy.deepcopy(host).double()

    def caches(prefix, st):
        if not args.caches:
            return {}
        # a recurrent state is one tensor, an attention cache a tuple
        # copies: a decode step writes the attention caches in place
        return {f"{prefix} {c} {name} {j}": a.to("cpu", torch.float64,
                                                 copy=True)
                for c, layer in enumerate(st.caches)
                for name, cache in layer.items()
                for j, a in enumerate([cache] if torch.is_tensor(cache)
                                      else cache)}

    def run(params, d, batch, dt):
        last, st = M.prefill(params, cfg, {
            k: v.to(d, dt) if v.is_floating_point() else v.to(d)
            for k, v in batch.items()})
        st = state_from_prefill(cfg, st, s_max, cache_dtype=dt)
        got = {"prefill": last.cpu().double(), **caches("padded cache", st)}
        for i in range(args.steps):
            lg, st = M.decode_step(params, cfg, st, forced[:, i:i + 1].to(d))
            got["step" if args.steps == 1 else f"step {i}"] = \
                lg[:, 0].cpu().double()
        got.update(caches("cache", st))
        return got

    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "window": cfg.local_window, "steps": args.steps,
           "card": cs._card_line(), "tol": cs.DEC_TOL, "by_batch": {}}
    for b in args.batch or [1]:
        rng = np.random.default_rng(3)
        batch = cs._decode_batch(cfg, rng, b, "cpu")
        forced = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, args.steps)).astype(np.int32))
        got = {"card": run(card, dev, batch, torch.float32),
               "cpu": run(host, "cpu", batch, torch.float32),
               "f64": run(wide, "cpu", batch, torch.float64)}
        out["by_batch"][b] = {
            what: {f"{x}-{y}": _stats(got[x][what], got[y][what],
                                      cs.DEC_TOL)
                   for x, y in (("card", "cpu"), ("card", "f64"),
                                ("cpu", "f64"))}
            for what in got["f64"]}
        print(f"[batch {b}] " + json.dumps(out["by_batch"][b]))
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
