"""granite-moe-1b-a400m's decode logits and router choices over 4 gloo
ranks in f32, as (data 1, model 4) and (data 2, model 2), against one
process's on the same weights in f32 and in f64: where the ranks'
tokens part from one process's, whether the split products are wrong
or their rounding moves a router across a near tie.

For each layout it prints, from ``chip_train_ranks.decode_logits`` (the
prompt's last logits and a first step's logits, the step fed the
prompt's first token) with every router call recorded:

* each rank's logits block against one process's f32 columns, as the
  L2 distance over one process's own rounding (its f32 against its
  f64), the ratio ``chip_smoke.py`` gates at ``DEC_SPLIT_FACTOR``;
* the router choices (call, token) whose expert set differs between
  the ranks and one process in f32, and between one process's f32 and
  f64, with each one's margin in f64 (the gap between the k-th and the
  (k+1)-th probability over the k-th; 0 is a tie) beside the smallest
  margin of all the choices;
* at (1, 4), ``chip_smoke.py``'s gate on the same ranks' outputs
  (``_check_moe_decode``: one process fed the ranks' router choices).

  python3 tools/moe_decode_ranks.py            # on the card, full size
  PYTHONPATH=src python3 tools/moe_decode_ranks.py --cpu   # smoke size
"""
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
import chip_smoke as C  # noqa: E402
import chip_train_ranks as CT  # noqa: E402
from repro_torch.launch.ranks import spawn_ranks  # noqa: E402

ARCH = "granite-moe-1b-a400m"
LAYOUTS = ((1, 4), (2, 2))


def _argv(model_ranks, cpu):
    argv = C._ranks_decode_argv(ARCH, model_ranks)[1:]
    if cpu:
        argv[argv.index("--device") + 1] = "cpu"
        argv.append("--smoke")
    return argv


def ranks(rank, world, conf):
    """This rank's f32 logits blocks and router log at each layout."""
    import torch.distributed as dist
    dev = CT._device(conf)
    return {lay: CT.decode_logits(argv, dev, group=dist.group.WORLD,
                                  dtype="float32", routes=True)
            for lay, argv in conf["argv"].items()}


def report(lay, got, one):
    """The figures of one layout (module docstring)."""
    ratios = {}
    for g in got:
        width = g["last"].shape[1]
        cols = slice(g["model_index"] * width,
                     (g["model_index"] + 1) * width)
        for key in ("last", "first"):
            low = one[key][g["rows"], cols]
            rnd = float(np.linalg.norm(low - one["wide"][key][g["rows"],
                                                              cols]))
            split = float(np.linalg.norm(g[key] - low))
            ratios[key] = max(ratios.get(key, 0.0), split / rnd)
    wide = one["wide"]["routes"]
    flips, rounding, smallest = [], [], []
    for g in got:
        if g["model_index"]:
            continue                   # every model rank routes alike
        d = g["data_index"]
        margins = CT.route_margins(wide[d])
        smallest.append(float(min(m.min() for m in margins)))
        flips += [(d, c, t, float(margins[c][t])) for c, t in
                  CT.route_flips(g["routes"][0], one["routes"][d])]
        rounding += [(d, c, t, float(margins[c][t])) for c, t in
                     CT.route_flips(one["routes"][d], wide[d])]
    calls = len(wide[0])
    print(f"[moe] {ARCH} {lay} f32: logits blocks' L2 distance from one "
          f"process's over its own f32-f64 rounding, worst over the ranks "
          f"{ratios}; router calls a data block {calls} (prefill and one "
          f"step); choices that differ ranks vs one process (data block, "
          f"call, token, f64 margin) {flips[:12]} ({len(flips)} in all); "
          f"one process f32 vs f64 {rounding[:12]} ({len(rounding)}); "
          f"smallest margin of all {min(smallest)}", flush=True)


def main():
    cpu = "--cpu" in sys.argv[1:]
    dev = torch.device("cpu" if cpu else "cuda")
    card = "the CPU" if cpu else C._card_line()
    if not cpu:
        from repro_torch.kernels import _build
        _build.ensure_built()
    argvs = {lay: _argv(lay[1], cpu) for lay in LAYOUTS}
    outs = spawn_ranks(ranks, 4, args=({"argv": argvs, "device": dev.type},),
                       timeout=C.TR_TIMEOUT)
    for lay, argv in argvs.items():
        one = CT.decode_logits(argv, dev, blocks=lay[0], dtype="float32",
                               routes=True)
        if not cpu:
            C._free_card()
        report(lay, [o[lay] for o in outs], one)
        if lay == (1, 4):
            C._check_moe_decode(dev, f"{ARCH} {lay}", argv,
                                [o[lay] for o in outs])
    print(f"[moe] on {card}", flush=True)


if __name__ == "__main__":
    main()
