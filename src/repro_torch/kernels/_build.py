"""Build, load and count the port's CUDA kernels.

Every ``.cu`` file in ``csrc/`` is compiled by ``nvcc`` into its own
shared library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<stem>.so csrc/<stem>.cu

The libraries live in ``build/repro_torch_kernels/<hash>/`` under the
checkout, where ``<hash>`` covers the sources and the flags, so an edited
source builds anew and an unchanged one is loaded from disk.  The build
happens at the first CUDA launch (or an explicit :func:`ensure_built`),
never at import: a machine without ``nvcc`` imports the package and runs
its CPU path.  The sources compile in parallel, one ``nvcc`` each.

``LAUNCHES`` holds one launch counter per kernel; each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
its path went through the kernels.  Under ``runtime/spans.py``'s
``recording()``, the counter ``kernels.library_builds`` counts the
libraries ``nvcc`` compiled (none where the build directory holds them).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = (Path(__file__).resolve().parents[3] / "build"
               / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"merge": 0, "arrivals": 0, "wait": 0,
                            "wait_churn": 0, "topk": 0, "topk_select": 0}

_lock = threading.Lock()
_libs: Optional[Dict[str, ctypes.CDLL]] = None


def reset_launches() -> None:
    """Set every launch counter to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        found = "/usr/local/cuda/bin/nvcc"
        if not Path(found).exists():
            raise RuntimeError(
                "nvcc not found (set CUDA_HOME or put nvcc on PATH); the "
                "port's CUDA kernels cannot be built")
    return found


def build_dir() -> Path:
    """Directory holding the libraries of the current sources."""
    return _BUILD_ROOT / _digest()


def ensure_built() -> float:
    """Build what the current sources lack and load every library.

    Returns the seconds this call spent (0.0 once loaded), which the
    engine books as compile time.  Raises with ``nvcc``'s output when a
    source does not compile.
    """
    global _libs
    with _lock:
        if _libs is not None:
            return 0.0
        t0 = time.perf_counter()
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        procs = []
        for cu in _sources():
            lib = out / f"lib{cu.stem}.so"
            if lib.exists():
                continue
            tmp = out / f"lib{cu.stem}.so.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(cu)]
            procs.append((cu, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for cu, lib, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{cu.name}:\n{log}")
            else:
                os.replace(tmp, lib)    # atomic: other processes see
                #                         a whole library or none
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        if procs:
            from repro_torch.runtime.spans import count
            count("kernels.library_builds", len(procs))
        _libs = {cu.stem: ctypes.CDLL(str(out / f"lib{cu.stem}.so"))
                 for cu in _sources()}
        return time.perf_counter() - t0


def function(lib: str, name: str, argtypes, restype=ctypes.c_int):
    """The C function ``name`` of ``lib<lib>.so`` with its signature
    declared (a launcher returns a ``cudaError_t`` as int)."""
    if _libs is None:
        ensure_built()
    fn = getattr(_libs[lib], name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def check(code: int, kernel: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t "
                           f"{code}")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer (None -> NULL)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """The current CUDA stream of ``device``, read at call time (the
    server launches from its own dispatcher thread)."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
