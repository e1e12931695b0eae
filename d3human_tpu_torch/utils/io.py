"""Files of the stage artifacts (counterpart of
``d3human_tpu/utils/io.py``): OBJ and binary PLY reading and writing, in
the JAX package's text and byte layout, 8-bit PNG images written and
read, and the host-side compaction and welding of the extraction's
fixed-capacity meshes. Arrays may be numpy arrays or tensors on any
device."""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np


def host(a) -> np.ndarray:
    """A numpy array of ``a`` (a tensor is copied off its device)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def write_obj(path: str, verts, faces, normals=None, uv=None,
              uv_idx=None) -> None:
    """OBJ writer; with ``uv`` and ``uv_idx`` the faces are v/vt pairs."""
    verts, faces = host(verts), host(faces)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if normals is not None:
            for n in host(normals):
                f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        if uv is not None:
            for t in host(uv):
                f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        if uv is not None and uv_idx is not None:
            for t, tt in zip(faces + 1, host(uv_idx) + 1):
                f.write(f"f {t[0]}/{tt[0]} {t[1]}/{tt[1]} {t[2]}/{tt[2]}\n")
        else:
            for t in faces + 1:
                f.write(f"f {t[0]} {t[1]} {t[2]}\n")


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(verts [V, 3] float32, faces [F, 3] int64) of an OBJ: the first
    three corners of each face, texture and normal indices dropped."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                faces.append([int(p.split("/")[0]) - 1 for p in parts[1:4]])
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int64).reshape(-1, 3))


def write_ply(path: str, verts, faces,
              vert_colors: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY; ``vert_colors`` in [0, 1] as 8-bit rgb."""
    verts = host(verts).astype(np.float32)
    faces = host(faces).astype(np.int32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(verts)}",
              "property float x", "property float y", "property float z"]
    if vert_colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {len(faces)}",
               "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if vert_colors is None:
            f.write(verts.astype("<f4").tobytes())
        else:
            rec = np.zeros(len(verts),
                           dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = verts
            rec["rgb"] = np.clip(host(vert_colors) * 255, 0, 255).astype(
                np.uint8)
            f.write(rec.tobytes())
        rec = np.zeros(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        rec["n"] = 3
        rec["idx"] = faces
        f.write(rec.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(verts, faces) of a PLY that ``write_ply`` wrote (colors skipped)."""
    with open(path, "rb") as f:
        n_verts = n_faces = 0
        has_color = False
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element vertex"):
                n_verts = int(line.split()[-1])
            elif line.startswith("element face"):
                n_faces = int(line.split()[-1])
            elif line.startswith("property uchar red"):
                has_color = True
            elif line == "end_header":
                break
        if has_color:
            rec = np.frombuffer(f.read(n_verts * 15),
                                dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            verts = np.array(rec["xyz"], np.float32)
        else:
            verts = np.frombuffer(f.read(n_verts * 12), "<f4").reshape(
                n_verts, 3).copy()
        rec = np.frombuffer(f.read(n_faces * 13),
                            dtype=[("n", "u1"), ("idx", "<i4", 3)])
        return verts, np.array(rec["idx"], np.int64)


def save_image(path: str, img) -> None:
    """Linear [0, 1] float image [H, W], [H, W, 1], [H, W, 3] or
    [H, W, 4] -> 8-bit PNG (gray, RGB or RGBA), values clipped and
    truncated as the JAX package's writer does. Written with the standard
    library alone (zlib, filter 0 on every row)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.clip(host(img) * 255, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    H, W = arr.shape[:2]
    color = {2: 0, 3: {3: 2, 4: 6}.get(arr.shape[-1])}[arr.ndim]
    if color is None:
        raise ValueError(f"save_image: {arr.shape[-1]} channels")
    rows = np.ascontiguousarray(arr).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], 1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


# colour type -> samples per pixel, for 8-bit non-interlaced images
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_png_lib = None


def _unfilter(path: str, raw: bytes, H: int, stride: int,
              bpp: int) -> np.ndarray:
    """The image bytes [H, stride] of the inflated scanlines ``raw``,
    unfiltered by the native library (``native/png.cpp``)."""
    import ctypes

    global _png_lib
    if _png_lib is None:
        from d3human_tpu_torch.native import load_lib

        lib = load_lib("png")
        lib.png_unfilter.restype = ctypes.c_int64
        lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int32]
        _png_lib = lib
    if len(raw) != H * (stride + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, "
                         f"expected {H * (stride + 1)}")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((H, stride), np.uint8)
    bad = _png_lib.png_unfilter(src.ctypes.data, out.ctypes.data, H, stride,
                                bpp)
    if bad:
        raise ValueError(f"{path}: row {bad - 1} has an unknown filter "
                         "type")
    return out


def load_image(path: str) -> np.ndarray:
    """An 8-bit PNG as a uint8 array, as imageio reads it: [H, W] for
    grey, [H, W, 2] grey with alpha, [H, W, 3] RGB, [H, W, 4] RGBA; a
    palette image expands to RGB, or to RGBA when it has a ``tRNS``
    chunk. Non-interlaced, any of the five scanline filters. Other bit
    depths and Adam7 interlace raise ``ValueError``, as does a chunk whose
    CRC does not match. The unfilter is native code and is never done in
    Python: a library that cannot be built raises ``native.BuildError``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr, plte, trns = 8, [], None, None, None
    while pos + 12 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4 or struct.unpack(">I", crc)[0] \
                != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: chunk {tag!r} is truncated or its "
                             "CRC does not match")
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    W, H, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in _PNG_CHANNELS:
        raise ValueError(f"{path}: bit depth {depth}, colour type {color}: "
                         "only 8-bit images are read")
    if interlace:
        raise ValueError(f"{path}: Adam7 interlace is not read")
    ch = _PNG_CHANNELS[color]
    px = _unfilter(path, zlib.decompress(b"".join(idat)), H, W * ch, ch)
    if color == 3:
        if plte is None:
            raise ValueError(f"{path}: palette image without PLTE")
        if trns is not None:
            alpha = np.full((len(plte),), 255, np.uint8)
            alpha[:len(trns)] = trns[:len(plte)]
            plte = np.concatenate([plte, alpha[:, None]], 1)
        return plte[px]
    return px.reshape(H, W) if ch == 1 else px.reshape(H, W, ch)


def compact_mesh(verts, faces, face_valid) -> Tuple[np.ndarray, np.ndarray]:
    """The valid faces of a fixed-capacity mesh over only the vertices they
    use, indices remapped (int64)."""
    faces = host(faces)[host(face_valid)]
    used, inv = np.unique(faces.reshape(-1), return_inverse=True)
    return host(verts)[used], inv.reshape(-1, 3).astype(np.int64)


def weld_mesh(verts, faces, tol: float = 1e-6
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge vertices that coincide at ``tol`` (the extraction emits
    duplicates where the surface passes through a lattice vertex) and drop
    the faces that degenerate."""
    verts, faces = host(verts), host(faces)
    q = np.round(verts / tol).astype(np.int64)
    _, first, inv = np.unique(q, axis=0, return_index=True,
                              return_inverse=True)
    new_faces = inv.reshape(-1)[faces]
    ok = ((new_faces[:, 0] != new_faces[:, 1])
          & (new_faces[:, 1] != new_faces[:, 2])
          & (new_faces[:, 0] != new_faces[:, 2]))
    new_faces = new_faces[ok]
    used, inv2 = np.unique(new_faces.reshape(-1), return_inverse=True)
    return verts[first][used], inv2.reshape(-1, 3).astype(np.int64)
