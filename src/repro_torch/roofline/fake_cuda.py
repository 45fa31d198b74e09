"""Fake CUDA tensors on a torch built without CUDA.

``FakeTensorMode`` makes tensors on ``cuda`` without a card, but a
torch built without CUDA has no CUDA device guard, which its C++ side
asks for where a tensor is indexed (``x[None]``) or an autograd node is
recorded, and raises.  :func:`ensure_guard` compiles ``fake_cuda.cpp``
with the host's C++ compiler against torch's own headers (a few
seconds, once: the library is kept in ``build/repro_torch_fake_cuda/``
under the checkout, keyed by the source and torch's version) and
registers its no-op guard.  That carries a forward pass; a backward
still needs a CUDA build, whose engine asks for CUDA streams
(``launch/dryrun.py::trace_device``).  Where torch has CUDA this does
nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent / "fake_cuda.cpp"
_BUILD_ROOT = (Path(__file__).resolve().parents[3] / "build"
               / "repro_torch_fake_cuda")
_lock = threading.Lock()
_lib = None


def ensure_guard() -> None:
    """Register the no-op CUDA device guard once in this process, where
    torch has no CUDA."""
    global _lib
    if torch.backends.cuda.is_built():
        return
    with _lock:
        if _lib is not None:
            return
        key = hashlib.sha256(_SRC.read_bytes() + torch.__version__.encode())
        out = _BUILD_ROOT / key.hexdigest()[:16]
        lib = out / "libfake_cuda.so"
        if not lib.exists():
            out.mkdir(parents=True, exist_ok=True)
            cxx = shutil.which("c++") or shutil.which("g++")
            if cxx is None:
                raise RuntimeError("no C++ compiler to build the fake CUDA "
                                   "guard for a torch without CUDA")
            root = Path(torch.__file__).resolve().parent
            tmp = out / f"libfake_cuda.so.{os.getpid()}.tmp"
            proc = subprocess.run(
                [cxx, "-shared", "-fPIC", "-std=c++17", "-O1",
                 f"-I{root / 'include'}", str(_SRC), f"-L{root / 'lib'}",
                 "-lc10", f"-Wl,-rpath,{root / 'lib'}", "-o", str(tmp)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("building the fake CUDA guard failed:\n"
                                   + proc.stdout + proc.stderr)
            os.replace(tmp, lib)
        _lib = ctypes.CDLL(str(lib))
        _lib.repro_register_fake_cuda_guard.restype = ctypes.c_int
        _lib.repro_register_fake_cuda_guard()
