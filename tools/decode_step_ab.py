"""Time the LM decode step of several checkouts on one card, in turns.

    python3 tools/decode_step_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repository (for
example ``git archive <commit>`` unpacked).  For each, in the order
given, a fresh process builds that checkout's kernels and runs its
``chip_smoke._decode_model``: qwen2-0.5b at full size, batch 4, a
32-token prompt, 16 vocabulary peers, each decode step timed with the
card synchronised (``step_ms_mean_warm``: the mean of the warm steps).
Prints one JSON line a run and the card's name and power limit.  Two
checkouts are compared only within one call of this script.
"""
import json
import os
import subprocess
import sys

_RUN = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as C
from repro_torch.kernels import _build
_build.ensure_built()
_, res = C._decode_model(torch.device("cuda"), C._card_line())
print("RESULT " + json.dumps({k: res[k] for k in
      ("step_ms_mean_warm", "loop_s", "tok_per_s")}))
"""


def main(argv):
    if not argv:
        raise SystemExit(__doc__)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    for root in argv:
        out = subprocess.run([sys.executable, "-c", _RUN], cwd=root,
                             env=dict(os.environ, PYTHONPATH="src"),
                             capture_output=True, text=True, timeout=600)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if out.returncode != 0 or not lines:
            raise SystemExit(f"{root}: exit {out.returncode}\n"
                             f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
        print(json.dumps({"tree": root, **json.loads(lines[0][7:])}))
    print(card)


if __name__ == "__main__":
    main(sys.argv[1:])
