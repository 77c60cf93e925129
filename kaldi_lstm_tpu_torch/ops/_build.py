"""Build the package's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``). The library's
file name carries a hash of its source, of every header in ``csrc/``
(``*.cuh``, ``*.h``) and of the compiler flags, so an edit to any of
them rebuilds it and an unchanged source is reused. Output goes to
``kaldi_lstm_tpu_torch/_build/`` (listed in ``.gitignore``). A build is
written to a temporary name and renamed into place, so concurrent
processes never load a half-written library.

Nothing here runs at import time: the CPU tests import every module on
machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC_DIR), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
# name -> (seconds, nvcc's output incl. -Xptxas -v register/smem report)
BUILD_LOG: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR)
                     if f.endswith((".cuh", ".h")))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}.{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for csrc/<name>.cu; returns (proc, tmp, lib, t0) or
    None when the library is already built."""
    lib = _lib_path(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, lib, t0 = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)
    BUILD_LOG[name] = (time.perf_counter() - t0, out)


def kernel_names() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def build_all() -> None:
    """Compile every csrc/*.cu that is not built yet, one nvcc per
    source, all started together."""
    with _LOCK:
        started = {n: _start(n) for n in kernel_names()}
        for n, s in started.items():
            if s is not None:
                _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            s = _start(name)
            if s is not None:
                _finish(name, s)
            lib = ctypes.CDLL(_lib_path(name))
            _LOADED[name] = lib
        return lib
