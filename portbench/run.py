#!/usr/bin/env python3
"""One run of one cell of ``BENCHMARK.json``:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout; prints one JSON line last on standard
output (see ``portbench/harness.py``)."""
import time

_T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
# the interpreter's own cache: where the installed packages' directories
# cannot be written, every process would compile the sources it imports
# anew (seconds of torch); a fixed directory of the checkout keeps them
sys.pycache_prefix = str(_ROOT / "build" / "pycache")
sys.path[0] = str(_ROOT)
sys.path.insert(1, str(_ROOT / "src"))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], _T0))
