"""Build and load the port's native libraries; count the launches of its
hand-written CUDA kernels.

Every ``csrc/<name>.cu`` (``nvcc``, ``sm_90a``) and ``native/<name>.cpp``
(``g++``) compiles into its own ``build/lib<name>.so`` with a plain C
interface, loaded with ``ctypes``, on first use when it is missing or older
than its source (``build_libs``). Nothing here runs at import time.

A kernel wrapper registers where it is defined (``counted``) and launches
through ``launch``, which adds to its ``launches``; it bumps its ``calls``
itself (plain attributes, counted on CUDA tensors only). ``count_path``
counts the paths code takes (``mlp_fused`` / ``mlp_fallback``: the fields
MLP's input and hidden layers on each path) on every device.
"""

from __future__ import annotations

import collections
import ctypes
import importlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, NamedTuple, Sequence, Tuple

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.RLock()
_libs: Dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """A native library could not be built or loaded."""


class Kernel(NamedTuple):
    fn: Callable            # the wrapper, which holds the counts
    source: str             # its library, csrc/<source>.cu
    signatures: Dict[str, Sequence]


_kernels: Dict[str, Kernel] = {}
_paths: collections.Counter = collections.Counter()


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found: the CUDA kernels of "
                         "d3human_tpu_torch need the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def build_libs(libs: Iterable[Tuple[Path, Path]], force: bool = False
               ) -> None:
    """Compile each (source, library) pair whose library is missing or
    older than its source (each with ``force``), all compilers at once:
    ``nvcc`` for a ``.cu``, ``g++`` for a ``.cpp``. Each writes a temporary
    file that replaces the library atomically, so processes that build at
    once do not see a half-written library."""
    with _lock:
        todo = [(src, lib) for src, lib in libs if force or not lib.exists()
                or lib.stat().st_mtime < src.stat().st_mtime]
        procs = []
        for src, lib in todo:
            lib.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = ([_nvcc(), *NVCC_FLAGS] if src.suffix == ".cu"
                   else ["g++", *GXX_FLAGS]) + ["-o", str(tmp), str(src)]
            try:
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT)
            except OSError as e:
                raise BuildError(f"{cmd[0]} could not run: {e}") from e
            procs.append((src, lib, tmp, proc))
        errors = []
        for src, lib, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{out.decode(errors='replace')}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, lib)
        if errors:
            raise BuildError("build failed on " + "\n".join(errors))


def build(names: Iterable[str] = SOURCES, force: bool = False) -> None:
    """Compile the named CUDA sources (``build_libs``)."""
    build_libs([(CSRC / f"{n}.cu", lib_path(n)) for n in names], force)


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


def counted(source: str, signatures: Dict[str, Sequence],
            floor: bool = False) -> Callable:
    """Decorator registering a kernel wrapper of ``csrc/<source>.cu`` under
    its name, with zeroed ``launches`` and ``calls``; with ``floor``, the
    resolve's ``floor_launches`` (its depth-peel launches) instead of
    ``calls``, as it launches once a call."""
    def register(fn: Callable) -> Callable:
        fn.launches = 0
        if floor:
            fn.floor_launches = 0
        else:
            fn.calls = 0
        _kernels[fn.__name__] = Kernel(fn, source, signatures)
        return fn
    return register


def launch(wrapper: Callable, fn: str, *args, device,
           launches: int = 1) -> None:
    """Call the C function ``fn`` of ``wrapper``'s library with ``args``
    and the current stream of ``device``, raise on a launch error, and add
    ``launches`` to ``wrapper.launches``."""
    kernel = _kernels[wrapper.__name__]
    err = getattr(load(kernel.source, kernel.signatures), fn)(
        *args, stream_ptr(device))
    check(err, fn)
    wrapper.launches += launches


def registered() -> Dict[str, Kernel]:
    """Every kernel wrapper by name, once each module of ``ops/`` has been
    imported (a wrapper registers when its module loads)."""
    for path in sorted(Path(__file__).parent.glob("[!_]*.py")):
        importlib.import_module(f"{__package__}.{path.stem}")
    return _kernels


def count_path(name: str, n: int) -> None:
    _paths[name] += n


def path_counts() -> Dict[str, int]:
    """The path counters since ``reset_counts`` (0 for a path not taken)."""
    return collections.Counter(_paths)


def reset_counts() -> None:
    """Zero every kernel wrapper's counters and every path counter."""
    for k in registered().values():
        for attr in ("launches", "calls", "floor_launches"):
            if hasattr(k.fn, attr):
                setattr(k.fn, attr, 0)
    _paths.clear()


def read_counts() -> dict:
    """Kernel launches since ``reset_counts`` by wrapper name, and under
    ``calls`` each wrapper's calls; the resolve's launches with a floor
    count as ``resolve_tiles_peel``, and its calls are its launches. Calls
    differ from launches where a call launches other than once: first_k,
    the scatter, the scan, and the fields MLP's kernels (calls of the
    forwards; a backward or input gradient launches twice)."""
    launches, calls = {}, {}
    for name, k in sorted(registered().items()):
        if hasattr(k.fn, "floor_launches"):
            peel = k.fn.floor_launches
            launches[name] = calls[name] = k.fn.launches - peel
            launches[f"{name}_peel"] = calls[f"{name}_peel"] = peel
        else:
            launches[name], calls[name] = k.fn.launches, k.fn.calls
    return dict(launches, calls=calls)
