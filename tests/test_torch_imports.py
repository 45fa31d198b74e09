"""The port stands alone: no JAX, nothing of the reference package, and
no ``ml_dtypes`` (a package that ships with JAX, absent where the card
is).

Importing every module of ``repro_torch`` in a fresh interpreter leaves
``jax``, ``repro`` and ``ml_dtypes`` out of ``sys.modules``; a scan of
the sources (and of ``chip_smoke.py`` and the tools that drive the port
on the card) finds no import of any of them; and ``chip_smoke.py``
fails, printing no result, where no CUDA device is present.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|repro|ml_dtypes)(?:\.|\s|$|,)",
    re.MULTILINE)
_FORBIDDEN_MODULES = ("jax", "repro", "ml_dtypes")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_and_no_reference():
    mods = list(_modules())
    assert "repro_torch.engine.sim_torch" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{_FORBIDDEN_MODULES!r})\n"
            "print('BAD', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_import_neither_jax_nor_reference():
    files = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("*.py")))
    hits = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
            for p in files for m in _FORBIDDEN.finditer(p.read_text())]
    assert not hits, hits
    # the scan itself catches what it must
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from repro.engine import SimEngine")
    assert _FORBIDDEN.search("import ml_dtypes")
    assert _FORBIDDEN.search("    from ml_dtypes import bfloat16")
    assert not _FORBIDDEN.search("from repro_torch.engine import x")


def test_chip_smoke_fails_without_a_cuda_device():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
