"""Per-tile z-buffer resolve of the rasterizer, on packed integer keys.

Counterpart of ``d3human_tpu/ops/pallas_raster.py``. Each tile of th x tw
pixels tests its pixel centres against M fused 16-float face rows
``[A0x A0y A1x A1y A2x A2y | C0 C1 C2 | az bz cz | live | pad3]`` and keeps
the minimum of ``key = (zq << 10) | slot`` (zq the 21-bit quantized depth);
``MISS_KEY`` marks background. With ``floor`` (a previous call's keys) only
keys strictly above it compete — one depth-peel step.

On a CUDA tensor ``resolve_tiles`` launches the hand-written kernel
``csrc/raster_resolve.cu`` (which replaces the Pallas kernel
``d3human_tpu/ops/pallas_raster.py:64 _resolve_body``; the source note there
says what bounds it). On a CPU tensor it runs ``resolve_tiles_plain``.

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

_SIG = {"d3h_resolve_tiles": (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p)}


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


def resolve_tiles_plain(tile_rows: torch.Tensor, tile: Tuple[int, int],
                        ntx: int, floor: Optional[torch.Tensor] = None,
                        tiles_per_chunk: int = 32) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [NT, M, 16] -> keys [NT, P]."""
    NT, M, _ = tile_rows.shape
    th, tw = tile
    dev = tile_rows.device
    out = []
    for t0 in range(0, NT, tiles_per_chunk):
        t1 = min(NT, t0 + tiles_per_chunk)
        px, py = _pixel_centres(t0, t1, th, tw, ntx, dev)
        px, py = px[..., None], py[..., None]                  # [nt, P, 1]
        best = torch.full(px.shape[:2], MISS_KEY, dtype=torch.int32,
                          device=dev)
        for b in range(0, M, BLOCK):
            r = tile_rows[t0:t1, None, b:b + BLOCK]             # [nt,1,B,16]

            def lin(k0, k1, k2):
                return _fma(py, r[..., k1], px * r[..., k0]) + r[..., k2]

            e0, e1, e2 = lin(0, 1, 6), lin(2, 3, 7), lin(4, 5, 8)
            inside = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                      | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
            z = lin(9, 10, 11)
            hit = inside & (r[..., 12] > 0.5)
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


def resolve_tiles(tile_rows: torch.Tensor, tile: Tuple[int, int], ntx: int,
                  floor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed keys [NT, th*tw] int32 (MISS_KEY = background)."""
    NT, M, W = tile_rows.shape
    th, tw = tile
    if W != ROW_W or M % BLOCK or M > (1 << SLOT_BITS):
        raise ValueError(f"resolve_tiles: rows must be [NT, M, 16] with M a "
                         f"multiple of {BLOCK} and <= 1024, got "
                         f"{tuple(tile_rows.shape)}")
    if tile_rows.device.type == "cpu":
        return resolve_tiles_plain(tile_rows, tile, ntx, floor)
    if tile_rows.device.type != "cuda":
        raise ValueError(f"resolve_tiles: unsupported device "
                         f"{tile_rows.device}")
    if tile_rows.dtype != torch.float32 or th * tw > 1024:
        raise ValueError("resolve_tiles: float32 rows and th*tw <= 1024 "
                         "pixels per tile")
    tile_rows = tile_rows.contiguous()
    if floor is not None:
        floor = floor.to(torch.int32).contiguous()
    out = torch.empty((NT, th * tw), dtype=torch.int32,
                      device=tile_rows.device)
    if NT == 0:
        return out
    lib = cuda_lib.load("raster_resolve", _SIG)
    cuda_lib.check(lib.d3h_resolve_tiles(
        tile_rows.data_ptr(), 0 if floor is None else floor.data_ptr(),
        NT, M, th, tw, ntx, out.data_ptr(),
        cuda_lib.stream_ptr(tile_rows.device)), "resolve_tiles")
    resolve_tiles.launches += 1
    if floor is not None:
        resolve_tiles.floor_launches += 1
    return out


resolve_tiles.launches = 0          # every launch of the kernel
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
