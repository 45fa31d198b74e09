"""Host cost of launching the top-k and merge kernels through their ops.

    python3 tools/kernel_op_overhead.py [CALLS] [ROUNDS]

``topk_cuda`` and ``merge_cuda`` launch through the ops
``repro_torch::topk`` / ``repro_torch::merge`` (the dispatcher, then the
wrapper's launch); ``topk._launch`` and ``merge._merge`` are the launches
alone.  At qwen2-0.5b's decode shapes (phase 11 of ``chip_smoke.py``:
batch 4 x 16 vocabulary peers = 64 rows of 9,600 scores, k = 20; merges
of (64, 20) f32 lists) this times CALLS calls of each path (default
2,000), the card synchronised before and after, in ROUNDS rounds
(default 6) that alternate which path goes first.  Prints one JSON line
a round (microseconds a call on each path, and the difference), then
the medians and the card's name and power limit.
"""
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir, "src"))


def _per_call_us(fn, calls):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def main(argv):
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.merge import merge as M
    from repro_torch.kernels.topk import topk as T

    calls = int(argv[0]) if argv else 2000
    rounds = int(argv[1]) if len(argv) > 1 else 6
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    _build.ensure_built()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    scores = torch.randn((64, 9600), generator=g, device=dev)
    va = torch.randn((64, 20), generator=g, device=dev).sort(
        dim=-1, descending=True).values
    vb = torch.randn((64, 20), generator=g, device=dev).sort(
        dim=-1, descending=True).values
    ia = torch.arange(20, dtype=torch.int32, device=dev).expand(64, 20)
    ia, ib = ia.contiguous(), (ia + 20).contiguous()
    paths = {
        "topk": (lambda: T.topk_cuda(scores, 20),
                 lambda: T._launch(scores, 20, 0)),
        "merge": (lambda: M.merge_cuda(va, ia, vb, ib),
                  lambda: M._merge(va, ia, vb, ib)),
    }
    for op, direct in paths.values():               # warm both paths
        op(), direct()
        if not (torch.equal(op()[0], direct()[0])
                and torch.equal(op()[1], direct()[1])):
            raise SystemExit("the op and the direct launch disagree")
    res = {name: {"op": [], "direct": []} for name in paths}
    for r in range(rounds):
        for name, (op, direct) in paths.items():
            order = (("op", op), ("direct", direct))
            for side, fn in (order if r % 2 == 0 else order[::-1]):
                res[name][side].append(_per_call_us(fn, calls))
            print(json.dumps({"round": r, "kernel": name,
                              "op_us": res[name]["op"][-1],
                              "direct_us": res[name]["direct"][-1],
                              "diff_us": res[name]["op"][-1]
                              - res[name]["direct"][-1]}))
    print(json.dumps({name: {side: statistics.median(v)
                             for side, v in sides.items()}
                      for name, sides in res.items()}))
    print(card)


if __name__ == "__main__":
    main(sys.argv[1:])
