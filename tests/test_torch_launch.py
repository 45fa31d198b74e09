"""The port's serving CLI (``repro_torch.launch.serve``) on the CPU.

Mirrors tests/test_serving.py::test_launch_overlay_serves_mixed_stream
with ``--device cpu``, in process and as ``python -m``; ``--device``
defaults to ``cuda`` and raises without a CUDA device; ``decode`` and
the flag-style invocation that routes to it exit with a message naming
the LM decode path as not ported, and decode nothing.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import serve as serve_mod

ROOT = Path(__file__).resolve().parents[1]
OVERLAY = ["overlay", "--topology", "ba,small-world", "--n-peers", "200",
           "--requests", "24", "--concurrency", "8",
           "--policies", "fd-dynamic,cn"]


def test_launch_overlay_serves_mixed_stream(capsys):
    metrics = serve_mod.main(OVERLAY + ["--batch-window-ms", "5",
                                        "--device", "cpu"])
    assert metrics["served"] == 24
    assert metrics["shed"] == 0 and metrics["timed_out"] == 0
    assert metrics["failed"] == 0
    assert metrics["throughput_qps"] > 0 and metrics["wall_s"] > 0
    assert metrics["max_batch"] >= 1
    assert metrics["latency"]["p50_s"] > 0
    out = capsys.readouterr().out
    assert "served 24/24 requests over 2 engine(s) [cpu]" in out
    assert "latency p50/p95/p99" in out


def test_launch_overlay_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *OVERLAY,
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "served 24/24 requests" in out.stdout
    assert "shed 0, timed out 0" in out.stdout


def test_overlay_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_mod.main(["overlay", "--n-peers", "50", "--requests", "2"])


@pytest.mark.parametrize("argv", [["decode"], ["decode", "--smoke"],
                                  ["--arch", "qwen2-0.5b"], []])
def test_decode_refuses_instead_of_decoding(argv):
    with pytest.raises(SystemExit, match="not ported") as exc:
        serve_mod.main(argv)
    assert "decode" in str(exc.value.code)
