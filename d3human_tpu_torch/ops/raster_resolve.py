"""Per-tile z-buffer resolve of the rasterizer, on packed integer keys.

Counterpart of ``d3human_tpu/ops/pallas_raster.py``. Each tile of th x tw
pixels tests its pixel centres against M fused 16-float face rows
``[A0x A0y A1x A1y A2x A2y | C0 C1 C2 | az bz cz | live | pad3]`` and keeps
the minimum of ``key = (zq << 10) | slot`` (zq the 21-bit quantized depth);
``MISS_KEY`` marks background. With ``floor`` (a previous call's keys) only
keys strictly above it compete — one depth-peel step.

``counts`` [NT] and ``global_range = (g0, n_global)`` name a tile's live
slots as the binning lays them out: ``[0, counts[t])`` its own near-to-far
list, ``[g0, g0 + n_global)`` the shared list of oversize faces (``n_global``
a tensor on the rows' device: nothing is read back). Only those slots are
walked; without ``counts`` all M are. A row's ``live`` flag is tested either
way. ``resolve_tiles_indexed`` takes the face table ``[F+1, 16]`` and the
slots' face ids ``[NT, M]`` int32 instead of one copied row per slot.

On a CUDA tensor both launch the hand-written kernel
``csrc/raster_resolve.cu`` (which replaces the Pallas kernel
``d3human_tpu/ops/pallas_raster.py:64 _resolve_body``; the source note there
says what bounds it and what the design does about it). On a CPU tensor they
run ``resolve_tiles_plain``.

Both evaluate the edge and depth functions with the rounding of the JAX
kernel's dots as XLA evaluates them (``acc = px*a; acc = fma(py, b, acc);
acc + c``), so keys agree bit for bit with the Pallas kernel in interpret
mode. The plain version forms each fused multiply-add in float64, where the
product is exact, and rounds once to float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from d3human_tpu_torch.ops import cuda_lib

SLOT_BITS = 10
Z_BITS = 21
Z_SCALE = float((1 << Z_BITS) - 1)
MISS_KEY = (1 << 31) - 1
ROW_W = 16
BLOCK = 128

# constants of csrc/raster_resolve.cu
CHUNK = 128     # slots per CTA: a tile's slots are cut over M / CHUNK CTAs
PIX = 4         # pixels of one column per thread (2 or 1 where 4 does not
                # divide th)

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIG = {"d3h_resolve_tiles": (
    _PTR, _PTR, _PTR, _PTR, _INT, _PTR, _INT, _INT, _INT, _INT, _INT, _PTR,
    _PTR)}


def pack_face_rows(A: torch.Tensor, C: torch.Tensor, az, bz, cz,
                   live: torch.Tensor) -> torch.Tensor:
    """[F,3,2] edge coefficients + [F,3] offsets + z-plane + live ->
    [F, 16] fused rows."""
    F = A.shape[0]
    return torch.cat([
        A.reshape(F, 6), C, az[:, None], bz[:, None], cz[:, None],
        live.float()[:, None],
        torch.zeros((F, 3), dtype=torch.float32, device=A.device),
    ], dim=-1)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, b, c), single rounding (a*b is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _pixel_centres(nt0: int, nt1: int, th: int, tw: int, ntx: int, device):
    t = torch.arange(nt0, nt1, device=device)
    ox = ((t % ntx) * tw).float()
    oy = ((t // ntx) * th).float()
    lin = torch.arange(th * tw, device=device)
    px = ((lin % tw).float() + 0.5)[None, :] + ox[:, None]     # [nt, P]
    py = ((lin // tw).float() + 0.5)[None, :] + oy[:, None]
    return px, py


def _slot_in_range(NT: int, M: int, counts, global_range, device):
    """[NT, M] bool: the slots the kernel walks."""
    if counts is None:
        return torch.ones((NT, M), dtype=torch.bool, device=device)
    slot = torch.arange(M, device=device)[None, :]
    walk = slot < counts[:, None]
    if global_range is not None:
        g0, n_global = global_range
        walk = walk | ((slot >= g0) & (slot < g0 + n_global.reshape(())))
    return walk


def resolve_tiles_plain(tile_rows: torch.Tensor, tile: Tuple[int, int],
                        ntx: int, floor: Optional[torch.Tensor] = None,
                        counts: Optional[torch.Tensor] = None,
                        global_range=None,
                        tiles_per_chunk: int = 32) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [NT, M, 16] -> keys [NT, P].
    With ``counts`` it skips the slots the kernel skips."""
    NT, M, _ = tile_rows.shape
    th, tw = tile
    dev = tile_rows.device
    walk = _slot_in_range(NT, M, counts, global_range, dev)
    out = []
    for t0 in range(0, NT, tiles_per_chunk):
        t1 = min(NT, t0 + tiles_per_chunk)
        px, py = _pixel_centres(t0, t1, th, tw, ntx, dev)
        px, py = px[..., None], py[..., None]                  # [nt, P, 1]
        best = torch.full(px.shape[:2], MISS_KEY, dtype=torch.int32,
                          device=dev)
        for b in range(0, M, BLOCK):
            w = walk[t0:t1, None, b:b + BLOCK]                  # [nt,1,B]
            if counts is not None and not bool(w.any()):
                continue
            r = tile_rows[t0:t1, None, b:b + BLOCK]             # [nt,1,B,16]

            def lin(k0, k1, k2):
                return _fma(py, r[..., k1], px * r[..., k0]) + r[..., k2]

            e0, e1, e2 = lin(0, 1, 6), lin(2, 3, 7), lin(4, 5, 8)
            inside = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                      | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
            z = lin(9, 10, 11)
            hit = inside & (r[..., 12] > 0.5) & w
            zq = torch.clamp((z + 1.0) * (0.5 * Z_SCALE), 0.0, Z_SCALE)
            slot = torch.arange(b, b + r.shape[2], dtype=torch.int32,
                                device=dev)
            key = (zq.to(torch.int32) << SLOT_BITS) | slot
            key = torch.where(hit, key, MISS_KEY)
            if floor is not None:
                fl = floor[t0:t1, :, None]
                key = torch.where(key > fl, key, MISS_KEY)
            best = torch.minimum(best, key.min(dim=-1).values)
        out.append(best)
    return torch.cat(out, dim=0)


def _resolve(rows: torch.Tensor, faces: Optional[torch.Tensor], NT: int,
             M: int, tile, ntx: int, floor, counts,
             global_range) -> torch.Tensor:
    """Check, launch and count: ``rows`` [NT, M, 16], or the face table
    read through ``faces`` [NT, M]."""
    th, tw = tile
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"resolve_tiles: unsupported device {dev}")
    if rows.dtype != torch.float32 or th * tw > 1024:
        raise ValueError("resolve_tiles: float32 rows and th*tw <= 1024 "
                         "pixels per tile")
    rows = rows.contiguous()

    def i32(x, shape, what):
        x = x.to(device=dev, dtype=torch.int32).contiguous()
        if tuple(x.shape) != shape:
            raise ValueError(f"resolve_tiles: {what} must have shape "
                             f"{shape}, got {tuple(x.shape)}")
        return x

    faces = None if faces is None else i32(faces, (NT, M), "faces")
    floor = None if floor is None else i32(floor, (NT, th * tw), "floor")
    counts = None if counts is None else i32(counts, (NT,), "counts")
    g0, n_global = 0, None
    if counts is not None and global_range is not None:
        g0 = int(global_range[0])
        n_global = i32(global_range[1].reshape(-1), (1,), "n_global")
    out = torch.empty((NT, th * tw), dtype=torch.int32, device=dev)
    if NT == 0:
        return out

    def ptr(x):
        return 0 if x is None else x.data_ptr()

    lib = cuda_lib.load("raster_resolve", _SIG)
    cuda_lib.check(lib.d3h_resolve_tiles(
        rows.data_ptr(), ptr(faces), ptr(floor), ptr(counts), g0,
        ptr(n_global), NT, M, th, tw, ntx, out.data_ptr(),
        cuda_lib.stream_ptr(dev)), "resolve_tiles")
    resolve_tiles.launches += 1
    if floor is not None:
        resolve_tiles.floor_launches += 1
    return out


def _check_slots(M: int, W: int, shape) -> None:
    if W != ROW_W or M % BLOCK or M > (1 << SLOT_BITS):
        raise ValueError(f"resolve_tiles: rows must be [.., 16] with M a "
                         f"multiple of {BLOCK} and <= 1024 slots per tile, "
                         f"got {tuple(shape)}")


def resolve_tiles(tile_rows: torch.Tensor, tile: Tuple[int, int], ntx: int,
                  floor: Optional[torch.Tensor] = None,
                  counts: Optional[torch.Tensor] = None,
                  global_range=None) -> torch.Tensor:
    """Packed keys [NT, th*tw] int32 (MISS_KEY = background) from one copied
    row per slot, ``tile_rows`` [NT, M, 16]."""
    NT, M, W = tile_rows.shape
    _check_slots(M, W, tile_rows.shape)
    if tile_rows.device.type == "cpu":
        return resolve_tiles_plain(tile_rows, tile, ntx, floor, counts,
                                   global_range)
    return _resolve(tile_rows, None, NT, M, tile, ntx, floor, counts,
                    global_range)


def resolve_tiles_indexed(rows: torch.Tensor, all_faces: torch.Tensor,
                          tile: Tuple[int, int], ntx: int,
                          floor: Optional[torch.Tensor] = None,
                          counts: Optional[torch.Tensor] = None,
                          global_range=None) -> torch.Tensor:
    """The same keys from the face table ``rows`` [F+1, 16] and the slots'
    face ids ``all_faces`` [NT, M] (F = the zero row): no row is copied."""
    NT, M = all_faces.shape
    _check_slots(M, rows.shape[1], all_faces.shape)
    if rows.device.type == "cpu":
        return resolve_tiles_plain(rows[all_faces.long()], tile, ntx, floor,
                                   counts, global_range)
    return _resolve(rows, all_faces, NT, M, tile, ntx, floor, counts,
                    global_range)


resolve_tiles.launches = 0          # every launch of the kernel, either form
resolve_tiles.floor_launches = 0    # those with a floor (depth-peel steps)


def unpack_keys(keys: torch.Tensor, tile_faces: torch.Tensor):
    """keys [NT, P] + tile_faces [NT, M] -> (tri_id+1 [NT,P], z [NT,P])."""
    miss = keys == MISS_KEY
    slot = (keys & ((1 << SLOT_BITS) - 1)).long().clamp(
        max=tile_faces.shape[1] - 1)
    zq = (keys >> SLOT_BITS).float()
    z = zq / (0.5 * Z_SCALE) - 1.0
    fid = torch.gather(tile_faces, 1, slot) + 1
    tri_id = torch.where(miss, 0, fid)
    z = torch.where(miss, 3.4e38, z)
    return tri_id, z
