"""The port's serving CLI (``repro_torch.launch.serve``) on the CPU.

Mirrors tests/test_serving.py::test_launch_overlay_serves_mixed_stream
with ``--device cpu``, in process and as ``python -m``; ``--device``
defaults to ``cuda`` and raises without a CUDA device, for ``overlay``,
``decode`` and the flag-style invocation that routes to ``decode``.
``decode --smoke --device cpu`` prints the reference's two lines and
returns the tokens (batch, gen), in process and as ``python -m``;
``--model-par 4`` (4 virtual peers, FD halving) samples the same tokens
as ``--model-par 1``; the same for the attention variants (minicpm3-4b:
MLA, whisper-large-v3: the encoder-decoder, qwen2-vl-72b: M-RoPE and
the vision stub), the MoE archs (granite-moe-1b-a400m,
moonshot-v1-16b-a3b), RWKV-6 (rwkv6-3b) and Griffin (recurrentgemma-2b)
at their smoke configs; a ``--model-par`` that does not divide the
padded vocabulary is refused.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs.base import get_config, smoke_config
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
def test_decode_refuses_instead_of_decoding(monkeypatch, argv):
    """Without a card, ``decode`` (and the bare flags that route to it)
    raises naming ``--device cpu`` before it builds anything."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu") as exc:
        serve_mod.main(argv)
    assert "serve decode" in str(exc.value)


DECODE = ["decode", "--smoke", "--batch", "2", "--prompt-len", "8",
          "--gen", "6", "--device", "cpu"]


def test_decode_smoke_on_the_cpu(capsys):
    toks = serve_mod.main(DECODE)
    assert toks.shape == (2, 6) and toks.dtype == np.int32
    cfg = smoke_config(get_config("qwen2-0.5b"))
    assert 0 <= toks.min() and toks.max() < cfg.padded_vocab()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen2-0.5b policy=fd-dynamic prefill 8 "
                             "tok in ")
    assert "decoded 5 steps in " in out[0] and "tok/s)" in out[0]
    assert out[1] == f"sample tokens: {toks[0, :12].tolist()}"


def test_decode_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *DECODE],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "arch=qwen2-0.5b policy=fd-dynamic" in out.stdout
    assert "sample tokens: [" in out.stdout


PEERS = [["--model-par", "4"], ["--model-par", "4", "--schedule", "ring"],
         ["--model-par", "4", "--policy", "cn-star"]]
VARIANTS = ("minicpm3-4b", "whisper-large-v3", "qwen2-vl-72b")
RECURRENT_MOE = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b", "rwkv6-3b",
                 "recurrentgemma-2b")


@pytest.mark.parametrize("extra", PEERS)
def test_decode_peers_sample_the_one_peer_tokens(extra):
    np.testing.assert_array_equal(
        serve_mod.main(DECODE + extra),
        serve_mod.main(DECODE + ["--model-par", "1"]))


@pytest.mark.parametrize("arch", VARIANTS + RECURRENT_MOE)
def test_decode_smoke_serves_the_attention_variants(capsys, arch):
    toks = serve_mod.main(DECODE + ["--arch", arch])
    assert toks.shape == (2, 6) and toks.dtype == np.int32
    cfg = smoke_config(get_config(arch))
    assert 0 <= toks.min() and toks.max() < cfg.padded_vocab()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch} policy=fd-dynamic prefill 8 ")
    assert out[1] == f"sample tokens: {toks[0, :12].tolist()}"


@pytest.mark.parametrize("arch", VARIANTS + RECURRENT_MOE)
@pytest.mark.parametrize("extra", PEERS)
def test_decode_variants_peers_sample_the_one_peer_tokens(arch, extra):
    np.testing.assert_array_equal(
        serve_mod.main(DECODE + ["--arch", arch] + extra),
        serve_mod.main(DECODE + ["--arch", arch, "--model-par", "1"]))


def test_decode_refuses_a_ragged_vocab_shard():
    with pytest.raises(ValueError, match="model=3 does not divide"):
        serve_mod.main(DECODE + ["--model-par", "3"])
