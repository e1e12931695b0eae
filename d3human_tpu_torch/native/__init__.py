"""Native (C++) host components of the port, built with ``g++`` at first
use into ``d3human_tpu_torch/build/`` (never next to the source) by
``ops/cuda_lib.py:build_libs``, the builder of the CUDA kernels too.

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
from pathlib import Path

from d3human_tpu_torch.ops.cuda_lib import BUILD, BuildError, build_libs

SRC = Path(__file__).resolve().parent


def lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def build_lib(name: str, force: bool = False) -> Path:
    """Compile ``build/lib<name>.so`` from ``<name>.cpp`` when it is missing
    or older than its source (``build_libs``); returns its path."""
    lib = lib_path(name)
    build_libs([(SRC / f"{name}.cpp", lib)], force)
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
