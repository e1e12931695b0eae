"""Native (C++) host components of the port, built with ``g++`` at first
use into ``d3human_tpu_torch/build/`` (never next to the source).

  * meshsdf: BVH + pseudonormal signed-distance queries, the host engine
    of the template surgery (``native/meshsdf.py``).
  * png: the scanline unfilter of the PNG reader (``utils/io.py``).
  * framecache: the mmap'd frame cache with a prefetch thread
    (``data/frame_cache.py``).

A library that cannot be built or loaded raises ``BuildError``. The PNG
reader and the frame cache pass it on (the cache reads a memmap only
when asked, ``native=False``); the mesh SDF's host entry point answers
with the tensor op instead (``ops/mesh_sdf.py:mesh_sdf_host``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent
BUILD = SRC.parent / "build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()


class BuildError(RuntimeError):
    """A native library could not be built or loaded."""


def lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def build_lib(name: str, force: bool = False) -> Path:
    """Compile ``build/lib<name>.so`` from ``<name>.cpp`` when it is missing
    or older than its source; returns its path. The compiler writes a
    temporary file that replaces the library atomically, so processes that
    build at once do not see a half-written library."""
    src, lib = SRC / f"{name}.cpp", lib_path(name)
    with _lock:
        if not force and lib.exists() and (
                lib.stat().st_mtime >= src.stat().st_mtime):
            return lib
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = BUILD / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = ["g++", *GXX_FLAGS, str(src), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise BuildError(f"g++ could not run: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise BuildError(f"g++ failed on {src.name}:\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def load_lib(name: str) -> ctypes.CDLL:
    """``build_lib(name)`` loaded with ctypes."""
    path = build_lib(name)
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise BuildError(f"cannot load {path}: {e}") from e


def build_framecache(force: bool = False) -> Path:
    """``build_lib("framecache")``: the frame cache's library, built when
    it is missing or older than its source (or with ``force``)."""
    return build_lib("framecache", force=force)
