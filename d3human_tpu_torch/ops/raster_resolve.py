"""Per-tile z-buffer resolve of the rasterizer, on packed integer keys.

Counterpart of ``d3human_tpu/ops/pallas_raster.py``, without its capacity.
Each tile of th x tw pixels tests its pixel centres against the fused
16-float face rows ``[A0x A0y A1x A1y A2x A2y | C0 C1 C2 | az bz cz | live |
pad3]`` of every face on its list and keeps the minimum of the int64
``key = (zq << 32) | pos``: zq the 21-bit quantized depth, pos the slot's
position in ``faces``, the binning's flat list of face ids. Tile t's own
faces, near to far, stand at ``[starts[t], starts[t+1])``; the oversize
faces, shared by every tile, at ``[big_base, big_base + n_big)``, after
every own list (``n_big`` a tensor on the rows' device: nothing is read
back). Within a tile that orders the slots as the Pallas kernel's slot
numbers do, its own list and then the shared one, so where a list fits the
Pallas kernel's 1,024 slots the winner and its depth are the Pallas
kernel's. ``MISS_KEY`` marks background. With ``floor`` (a previous call's
keys) only keys strictly above it compete — one depth-peel step.

On a CUDA tensor ``resolve_tiles`` launches the hand-written kernel
``csrc/raster_resolve.cu`` (which replaces the Pallas kernel
``d3human_tpu/ops/pallas_raster.py:64 _resolve_body``; the source note there
says what bounds it and what the design does about it). On a CPU tensor it
runs ``resolve_tiles_plain``. Either adds the (slot, tile) pairs it walked
to ``walked_pairs(device)``, a counter on the device that is never read
back by the resolve itself.

Both evaluate the edge and depth functions with the rounding of the JAX
kernel's dots as XLA evaluates them (``acc = px*a; acc = fma(py, b, acc);
acc + c``), so the depths agree bit for bit with the Pallas kernel in
interpret mode. The plain version forms each fused multiply-add in float64,
where the product is exact, and rounds once to float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from d3human_tpu_torch.ops import cuda_lib

Z_BITS = 21
Z_SCALE = float((1 << Z_BITS) - 1)
POS_BITS = 32
MISS_KEY = (1 << 63) - 1
ROW_W = 16
BLOCK = 128

# constants of csrc/raster_resolve.cu
CHUNK = 128     # slots of a list a CTA stages and walks at once
NY = 8          # CTAs per tile: CTA y walks the chunks y, y + NY, ...
PIX = 4         # pixels of one column per thread (2 or 1 where 4 does not
                # divide th)

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIG = {"d3h_resolve_tiles": (
    _PTR, _PTR, _PTR, _INT, _PTR, _PTR, _INT, _INT, _INT, _INT, _PTR, _PTR,
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


def walked_pairs(device) -> torch.Tensor:
    """The int64 [1] counter of the (slot, tile) pairs the resolve walked
    on ``device`` since the last ``reset_pairs``: each launch adds, for
    every tile it does not skip, its own list's length and ``n_big``."""
    device = torch.device(device)
    key = str(device)
    if key not in resolve_tiles.pairs:
        resolve_tiles.pairs[key] = torch.zeros(1, dtype=torch.int64,
                                               device=device)
    return resolve_tiles.pairs[key]


def reset_pairs() -> None:
    for t in resolve_tiles.pairs.values():
        t.zero_()


def resolve_tiles_plain(rows: torch.Tensor, faces: torch.Tensor,
                        starts: torch.Tensor, big_base: int,
                        n_big: torch.Tensor, tile: Tuple[int, int],
                        ntx: int, floor: Optional[torch.Tensor] = None,
                        tiles_per_chunk: int = 32) -> torch.Tensor:
    """Plain PyTorch version of the kernel: keys [NT, th*tw] int64. Tiles go
    ``tiles_per_chunk`` at a time, each chunk walking the slots up to its
    longest list and then the shared list, in blocks of ``BLOCK``."""
    NT = starts.shape[0] - 1
    th, tw = tile
    dev = rows.device
    F = rows.shape[0] - 1                     # row F is the zero row
    st = starts.long()
    lens = st[1:] - st[:-1]
    nb = int(n_big)
    lens_h = lens.cpu()
    glob = torch.arange(big_base, big_base + nb, device=dev)
    walked = 0
    out = []
    for t0 in range(0, NT, tiles_per_chunk):
        t1 = min(NT, t0 + tiles_per_chunk)
        px, py = _pixel_centres(t0, t1, th, tw, ntx, dev)
        px, py = px[..., None], py[..., None]                  # [nt, P, 1]
        best = torch.full(px.shape[:2], MISS_KEY, dtype=torch.int64,
                          device=dev)
        fl = None if floor is None else floor[t0:t1, :, None]
        todo = torch.ones(t1 - t0, dtype=torch.bool)
        if floor is not None:                  # every floor a miss: skip
            todo = (floor[t0:t1] != MISS_KEY).any(dim=1).cpu()
        todo &= (lens_h[t0:t1] > 0) | (nb > 0)
        walked += int((lens_h[t0:t1] + nb)[todo].sum())
        m_own = int(lens_h[t0:t1][todo].max()) if bool(todo.any()) else 0
        blocks = [(b, None) for b in range(0, m_own, BLOCK)]
        blocks += [(b, glob[b:b + BLOCK]) for b in range(0, nb, BLOCK)]
        for b, g in blocks:
            if g is None:
                slot = torch.arange(b, min(b + BLOCK, m_own), device=dev)
                pos = st[t0:t1, None] + slot[None, :]          # [nt, B]
                ok = slot[None, :] < lens[t0:t1, None]
                pos = torch.where(ok, pos, 0)
                fid = torch.where(ok, faces[pos.clamp(
                    max=faces.shape[0] - 1)].long(), F)
            else:
                pos = g[None, :].expand(t1 - t0, -1)
                fid = faces[g].long()[None, :].expand(t1 - t0, -1)
            r = rows[fid][:, None]                              # [nt,1,B,16]

            def lin(k0, k1, k2):
                return _fma(py, r[..., k1], px * r[..., k0]) + r[..., k2]

            e0, e1, e2 = lin(0, 1, 6), lin(2, 3, 7), lin(4, 5, 8)
            inside = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                      | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
            z = lin(9, 10, 11)
            hit = inside & (r[..., 12] > 0.5) & todo.to(dev)[:, None, None]
            zq = torch.clamp((z + 1.0) * (0.5 * Z_SCALE), 0.0, Z_SCALE)
            key = ((zq.to(torch.int64) << POS_BITS) | pos[:, None, :])
            key = torch.where(hit, key, MISS_KEY)
            if fl is not None:
                key = torch.where(key > fl, key, MISS_KEY)
            best = torch.minimum(best, key.min(dim=-1).values)
        out.append(best)
    walked_pairs(dev).add_(walked)
    if not out:
        return torch.empty((0, th * tw), dtype=torch.int64, device=dev)
    return torch.cat(out, dim=0)


@cuda_lib.counted("raster_resolve", _SIG, floor=True)
def resolve_tiles(rows: torch.Tensor, faces: torch.Tensor,
                  starts: torch.Tensor, big_base: int, n_big: torch.Tensor,
                  tile: Tuple[int, int], ntx: int,
                  floor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed keys [NT, th*tw] int64 (``MISS_KEY`` = background) from the
    face table ``rows`` [F+1, 16] (row F zero), the flat list ``faces``
    int32, the tiles' ranges ``starts`` [NT+1] int32 and the shared list at
    ``big_base`` of ``n_big`` (an int32 tensor) faces."""
    th, tw = tile
    NT = starts.shape[0] - 1
    if rows.dim() != 2 or rows.shape[1] != ROW_W:
        raise ValueError(f"resolve_tiles: rows must be [F+1, {ROW_W}], got "
                         f"{tuple(rows.shape)}")
    if faces.shape[0] >= (1 << 31) or th * tw > 1024:
        raise ValueError("resolve_tiles: fewer than 2^31 slots and th*tw "
                         "<= 1024 pixels per tile")
    if rows.device.type == "cpu":
        return resolve_tiles_plain(rows, faces, starts, big_base, n_big,
                                   tile, ntx, floor)
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"resolve_tiles: unsupported device {dev}")
    if rows.dtype != torch.float32:
        raise ValueError("resolve_tiles: float32 rows")
    rows = rows.contiguous()

    def i32(x, n, what):
        x = x.to(device=dev, dtype=torch.int32).contiguous().reshape(-1)
        if n is not None and x.shape[0] != n:
            raise ValueError(f"resolve_tiles: {what} must have {n} "
                             f"entries, got {x.shape[0]}")
        return x

    faces = i32(faces, None, "faces")
    starts = i32(starts, NT + 1, "starts")
    n_big = i32(n_big, 1, "n_big")
    if floor is not None:
        floor = floor.to(device=dev, dtype=torch.int64).contiguous()
        if tuple(floor.shape) != (NT, th * tw):
            raise ValueError(f"resolve_tiles: floor must have shape "
                             f"{(NT, th * tw)}, got {tuple(floor.shape)}")
    out = torch.empty((NT, th * tw), dtype=torch.int64, device=dev)
    if NT == 0:
        return out
    cuda_lib.launch(resolve_tiles, "d3h_resolve_tiles", rows.data_ptr(),
                    faces.data_ptr(), starts.data_ptr(), int(big_base),
                    n_big.data_ptr(), 0 if floor is None else floor.data_ptr(),
                    NT, th, tw, ntx, out.data_ptr(),
                    walked_pairs(dev).data_ptr(), device=dev)
    if floor is not None:
        resolve_tiles.floor_launches += 1
    return out


resolve_tiles.pairs = {}            # device -> walked_pairs' counter


def unpack_keys(keys: torch.Tensor, faces: torch.Tensor):
    """keys [NT, P] + the flat list ``faces`` -> (tri_id+1 [NT,P] int32,
    z [NT,P])."""
    miss = keys == MISS_KEY
    pos = (keys & ((1 << POS_BITS) - 1)).clamp(max=faces.shape[0] - 1)
    zq = (keys >> POS_BITS).float()
    z = zq / (0.5 * Z_SCALE) - 1.0
    fid = faces[pos] + 1
    tri_id = torch.where(miss, 0, fid).to(torch.int32)
    z = torch.where(miss, 3.4e38, z)
    return tri_id, z
