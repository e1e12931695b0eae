"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library ``build/lib<name>.so`` with a plain C interface, loaded with
``ctypes``. A library is (re)built on first use when it is missing or older
than its source; ``build_all`` starts one ``nvcc`` per source at once.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = ("first_k", "scatter", "raster_resolve", "scan", "softplus100",
           "linear_softplus")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "d3human_tpu_torch need the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    so, src = lib_path(name), CSRC / f"{name}.cu"
    return not so.exists() or so.stat().st_mtime < src.stat().st_mtime


def build(names: Iterable[str] = SOURCES, force: bool = False) -> None:
    """Compile the named sources, all ``nvcc`` processes in parallel.
    Each writes a temporary file that replaces the library atomically."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = BUILD / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu:\n{out.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(name))
    if errors:
        raise RuntimeError("nvcc failed\n" + "\n".join(errors))


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed.
    ``signatures`` maps each C function to its ctypes argument types; every
    function returns the ``cudaError_t`` of its launch as an int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
