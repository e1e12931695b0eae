"""Per-tile z-buffer resolve of the binned rasterizer, plain PyTorch and
without a capacity: every slot of a tile's list competes.

A pixel keeps the least ``(zq, slot)`` over the faces that cover it, zq the
depth quantized to ``Z_BITS`` bits; the edge and depth functions are
evaluated as ``fma(py, b, px * a) + c`` in float32, each fused
multiply-add formed in float64, where the product is exact, and rounded
once."""

from __future__ import annotations

from typing import List

import torch

Z_BITS = 21
Z_SCALE = float((1 << Z_BITS) - 1)
BLOCK = 128
MISS = (1 << 62)


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
    return (a.double() * b.double() + c.double()).float()


def _pixel_centres(nt0: int, nt1: int, th: int, tw: int, ntx: int, device):
    t = torch.arange(nt0, nt1, device=device)
    ox = ((t % ntx) * tw).float()
    oy = ((t // ntx) * th).float()
    lin = torch.arange(th * tw, device=device)
    px = ((lin % tw).float() + 0.5)[None, :] + ox[:, None]
    py = ((lin // tw).float() + 0.5)[None, :] + oy[:, None]
    return px, py


def resolve(rows: torch.Tensor, slot_faces: torch.Tensor,
            ranges: List[tuple], tile, ntx: int,
            tiles_per_chunk: int = 16) -> torch.Tensor:
    """int64 keys [NT, th*tw] (``MISS`` = background) of ``(zq << 32) |
    slot``: the face table ``rows`` [F+1, 16], the slots' face ids
    ``slot_faces`` [NT, M] and, per chunk of ``tiles_per_chunk`` tiles,
    the slot ranges ``ranges`` that hold a live face in some tile of the
    chunk (``[(s0, s1), ...]``, host ints)."""
    NT, M = slot_faces.shape
    th, tw = tile
    dev = rows.device
    out = []
    for c, t0 in enumerate(range(0, NT, tiles_per_chunk)):
        t1 = min(NT, t0 + tiles_per_chunk)
        px, py = _pixel_centres(t0, t1, th, tw, ntx, dev)
        px, py = px[..., None], py[..., None]
        best = torch.full(px.shape[:2], MISS, dtype=torch.int64, device=dev)
        for s0, s1 in ranges[c]:
            for b in range(s0, s1, BLOCK):
                e = min(b + BLOCK, s1)
                r = rows[slot_faces[t0:t1, b:e].long()][:, None]

                def lin(k0, k1, k2):
                    return _fma(py, r[..., k1], px * r[..., k0]) + r[..., k2]

                e0, e1, e2 = lin(0, 1, 6), lin(2, 3, 7), lin(4, 5, 8)
                inside = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                          | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
                z = lin(9, 10, 11)
                hit = inside & (r[..., 12] > 0.5)
                zq = torch.clamp((z + 1.0) * (0.5 * Z_SCALE), 0.0, Z_SCALE)
                slot = torch.arange(b, e, dtype=torch.int64, device=dev)
                key = (zq.to(torch.int64) << 32) | slot
                key = torch.where(hit, key, MISS)
                best = torch.minimum(best, key.min(dim=-1).values)
        out.append(best)
    return torch.cat(out, dim=0)


def unpack_keys(keys: torch.Tensor, slot_faces: torch.Tensor):
    """keys [NT, P] + slot_faces [NT, M] -> (tri_id+1 [NT,P], z [NT,P])."""
    miss = keys == MISS
    slot = (keys & 0xFFFFFFFF).clamp(max=slot_faces.shape[1] - 1)
    zq = (keys >> 32).float()
    z = zq / (0.5 * Z_SCALE) - 1.0
    fid = torch.gather(slot_faces, 1, slot) + 1
    tri_id = torch.where(miss, 0, fid).to(torch.int32)
    z = torch.where(miss, 3.4e38, z)
    return tri_id, z
