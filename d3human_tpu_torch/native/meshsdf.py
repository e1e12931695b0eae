"""ctypes binding of the native mesh-SDF engine (``meshsdf.cpp``): exact
BVH closest point and angle-weighted pseudonormal sign, thread-parallel
over the query points.

    sdf = MeshSDF(verts, faces)
    d = sdf.query(points)                           # negative inside
    d = sdf.query(points, sign_convention="pos_inside")
    d, cp, face = sdf.query(points, return_closest=True)

The library is built at first use (``native.build_lib``); a failure to
build or load it raises ``native.BuildError``. ``mesh_sdf_host`` is the
one-shot query; ``available()`` says whether the library can be built
and loaded (False only for a ``BuildError``: a missing or failing
toolchain).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from d3human_tpu_torch.native import BuildError, load_lib

_lib = None
_SIGN_MODE = {"neg_inside": 0, "pos_inside": 1, "unsigned": 2}
_F32 = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)


def _load():
    global _lib
    if _lib is None:
        lib = load_lib("meshsdf")
        lib.msdf_build.restype = ctypes.c_void_p
        lib.msdf_build.argtypes = [_F32, ctypes.c_int32, _I32,
                                   ctypes.c_int32]
        lib.msdf_free.argtypes = [ctypes.c_void_p]
        lib.msdf_query.argtypes = [
            ctypes.c_void_p, _F32, ctypes.c_int64, _F32, _F32, _I32,
            ctypes.c_int32, ctypes.c_int32]
        _lib = lib
    return _lib


def _rows3(a, dtype, what: str) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=dtype)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"{what} must be [N, 3], got {a.shape}")
    return a


class MeshSDF:
    """A BVH over a triangle soup (verts [V, 3], faces [F, 3])."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray):
        lib = _load()
        self._v = _rows3(verts, np.float32, "verts")
        self._f = _rows3(faces, np.int32, "faces")
        self._h = lib.msdf_build(self._v.ctypes.data_as(_F32),
                                 self._v.shape[0],
                                 self._f.ctypes.data_as(_I32),
                                 self._f.shape[0])
        if not self._h:
            raise RuntimeError("msdf_build failed (empty mesh?)")

    def query(self, points: np.ndarray, sign_convention: str = "neg_inside",
              return_closest: bool = False, n_threads: int = 0
              ) -> "np.ndarray | Tuple[np.ndarray, np.ndarray, np.ndarray]":
        """Signed distance [P] of points [P, 3]; with ``return_closest``
        also the closest surface points [P, 3] and their faces [P].
        ``n_threads`` 0: one thread per core."""
        pts = _rows3(points, np.float32, "points")
        n = pts.shape[0]
        out = np.empty((n,), np.float32)
        cp = np.empty((n, 3), np.float32) if return_closest else None
        face = np.empty((n,), np.int32) if return_closest else None
        _load().msdf_query(
            self._h, pts.ctypes.data_as(_F32), n, out.ctypes.data_as(_F32),
            None if cp is None else cp.ctypes.data_as(_F32),
            None if face is None else face.ctypes.data_as(_I32),
            _SIGN_MODE[sign_convention], n_threads)
        return (out, cp, face) if return_closest else out

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and _lib is not None:
            _lib.msdf_free(h)
            self._h = None


def mesh_sdf_host(points: np.ndarray, verts: np.ndarray, faces: np.ndarray,
                  sign_convention: str = "neg_inside") -> np.ndarray:
    """One query of the engine: the signed distance [P] of points [P, 3]
    to the mesh (numpy in and out). A failed build raises ``BuildError``;
    ``ops/mesh_sdf.py:mesh_sdf_host`` is the entry point that answers with
    the tensor op instead."""
    return MeshSDF(verts, faces).query(points, sign_convention)


def available() -> bool:
    """True when the library is built or can be, and loads."""
    try:
        _load()
    except BuildError:
        return False
    return True
