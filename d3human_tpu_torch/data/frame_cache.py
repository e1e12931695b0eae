"""Decode-once frame cache (counterpart of
``d3human_tpu/data/frame_cache.py``): ``build_cache`` writes a capture's
targets as packed fp16; ``FrameCacheReader`` serves them through the
native mmap / prefetch library (``native/framecache.cpp``), or through a
numpy memmap when the caller passes ``native=False``. The file is the JAX
package's, byte for byte: a header of four little-endian uint64 (magic,
frames, bytes per frame, 0), then per frame and pixel 9 fp16 channels,

    all_img   4   (rgb premultiplied, the alpha's sign)
    cloth_a   1
    body_a    1
    normal    3

so each package reads the other's cache. The CLI does not use it (nor
does the JAX CLI).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict

import numpy as np
import torch

from d3human_tpu_torch.utils.io import host

MAGIC = 0xD3DA7ACAFE
_lib = None


def frame_bytes(res) -> int:
    H, W = res
    return H * W * (4 + 1 + 1 + 3) * 2


def build_cache(dataset, cache_path: str) -> str:
    """Every frame of ``dataset`` (``frame_target(i)`` for i < len, tensors
    or numpy arrays) packed into ``cache_path``; returns the path."""
    H, W = dataset.train_res
    n = len(dataset)
    with open(cache_path, "wb") as f:
        f.write(struct.pack("<QQQQ", MAGIC, n, frame_bytes((H, W)), 0))
        for i in range(n):
            t = dataset.frame_target(i)
            rec = np.concatenate([
                host(t["all_img"]).reshape(H * W, 4),
                host(t["cloth_img"])[..., 3:].reshape(H * W, 1),
                host(t["body_img"])[..., 3:].reshape(H * W, 1),
                host(t["all_normal"]).reshape(H * W, 3),
            ], axis=1).astype(np.float16)
            f.write(rec.tobytes())
    return cache_path


def _load():
    global _lib
    if _lib is None:
        from d3human_tpu_torch.native import load_lib

        lib = load_lib("framecache")
        lib.fc_open.restype = ctypes.c_void_p
        lib.fc_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.fc_get_frame.restype = ctypes.c_int
        lib.fc_get_frame.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                     ctypes.c_void_p]
        lib.fc_n_frames.restype = ctypes.c_uint64
        lib.fc_n_frames.argtypes = [ctypes.c_void_p]
        lib.fc_frame_bytes.restype = ctypes.c_uint64
        lib.fc_frame_bytes.argtypes = [ctypes.c_void_p]
        lib.fc_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class FrameCacheReader:
    """The frames of a cache at ``res`` = (H, W), as target tensors on
    ``device``. The native library serves them (a library that cannot be
    built raises ``native.BuildError``); ``native=False`` reads through a
    numpy memmap instead."""

    def __init__(self, cache_path: str, res, ring: int = 4,
                 native: bool = True, device="cuda"):
        self.res = tuple(res)
        self.fb = frame_bytes(self.res)
        self.device = torch.device(device)
        self._native = self._handle = self._mm = None
        if native:
            lib = _load()
            h = lib.fc_open(cache_path.encode(), ring)
            if not h:
                raise ValueError(f"{cache_path}: not a frame cache")
            self._native, self._handle = lib, h
            self.n_frames = int(lib.fc_n_frames(h))
            fb = int(lib.fc_frame_bytes(h))
        else:
            with open(cache_path, "rb") as f:
                magic, self.n_frames, fb, _ = struct.unpack("<QQQQ",
                                                           f.read(32))
            if magic != MAGIC:
                raise ValueError(f"{cache_path}: not a frame cache")
            self._mm = np.memmap(cache_path, np.uint8, "r", offset=32)
        if fb != self.fb:
            self.close()
            raise ValueError(f"{cache_path}: {fb} bytes a frame, {self.fb} "
                             f"at {self.res}")

    def close(self):
        if self._native is not None and self._handle:
            self._native.fc_close(self._handle)
            self._handle = None

    def frame(self, idx: int) -> Dict[str, torch.Tensor]:
        """Frame ``idx``: all_img, cloth_img, body_img, the normals (float32
        on the device)."""
        H, W = self.res
        if not 0 <= idx < self.n_frames:
            raise IndexError(f"frame {idx} of {self.n_frames}")
        if self._native is not None:
            buf = np.empty(self.fb, np.uint8)
            if self._native.fc_get_frame(self._handle, idx,
                                         buf.ctypes.data) != 0:
                raise OSError(f"frame cache: frame {idx} not read")
        else:
            off = idx * self.fb
            buf = np.array(self._mm[off:off + self.fb])
        rec = torch.from_numpy(buf).to(self.device).view(
            torch.float16).reshape(H, W, 9).float()
        all_img, cloth_a, body_a, normal = (
            rec[..., 0:4], rec[..., 4:5], rec[..., 5:6], rec[..., 6:9])
        rgb = all_img[..., :3]
        return {
            "all_img": all_img,
            "cloth_img": torch.cat([rgb * cloth_a, cloth_a], -1),
            "body_img": torch.cat([rgb * body_a, body_a], -1),
            "all_normal": normal,
            "cloth_normal": normal * cloth_a,
            "body_normal": normal * body_a,
        }
