"""Differentiable rasterization, on compacted pixels for training and on
the dense image for validation (counterpart of
``d3human_tpu/ops/rasterizer.py``).

``rasterize`` is hard visibility only (no gradients): per-face screen setup,
tile binning by one stable sort of the int32 key ``(tile << 20) | zq`` that
carries the face ids, a global list for oversize faces, and the per-tile
resolve of ``ops/raster_resolve.py`` with the Pallas kernel's semantics
(quantized-z then slot order), which reads the face rows through the slots'
face ids and walks each tile's live slots only. ``layers > 1`` depth-peels:
the binning runs once and the resolve repeats with the previous layer's keys
as the floor.
``rasterize_bruteforce`` is the oracle: every pixel tests every live face
through ``_resolve_tile``, which orders by float (z, id) as the JAX
package's XLA path does (a pixel chunk skips the faces whose bounding box
misses its rows, which changes no answer). It is plain PyTorch on the
card too, by design:
the JAX package computes it outside any Pallas kernel (it renders the
synthetic ground truth and checks the binned rasterizer), so it is no
kernel port and has no CUDA counterpart.

Gradients come from ``barycentrics_compact`` (perspective-correct
barycentrics recomputed from clip-space corners at each covered pixel) and
from the sparse silhouette antialiasing of ``aa_geometry_compact`` /
``apply_aa_sparse``; the dense path has ``barycentrics`` / ``interpolate``
and ``aa_weights`` / ``apply_aa`` over every neighbour pair (``antialias``
is the two in one call).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from d3human_tpu_torch.ops.compaction import first_k_indices
from d3human_tpu_torch.ops.raster_resolve import (
    pack_face_rows, resolve_tiles_indexed, unpack_keys,
)
from d3human_tpu_torch.ops.scatter import (
    coo_scatter_add, gather_rows, scatter_rows_sorted, segment_add_rows,
)


class Rast(NamedTuple):
    tri_id: torch.Tensor      # [H, W] int: face index + 1; 0 = background
    zbuf: torch.Tensor        # [H, W] f32 z/w of the winner
    n_max_tile: Optional[torch.Tensor] = None   # longest per-tile face list
    n_big: Optional[torch.Tensor] = None        # oversize (global) faces


class Binned(NamedTuple):
    """Rasterizer setup: what the tile resolve consumes. A tile's live
    slots are ``[0, counts[t])`` (its own list, near to far) and
    ``[g0, g0 + n_global)`` with ``(g0, n_global) = global_range`` (the
    shared list of oversize faces, live ones first); every other slot holds
    face id F, the zero row."""

    rows: torch.Tensor        # [F+1, 16] fused face rows; row F is zero
    all_faces: torch.Tensor   # [NT, M] int32 face id per slot (F = dead)
    counts: torch.Tensor      # [NT] int32 slots of each tile's own list
    global_range: Tuple[int, torch.Tensor]  # (g0, n_global int32 tensor)
    starts: torch.Tensor      # [NT+1] per-tile ranges in the sorted pairs
    n_big: torch.Tensor       # oversize face count
    grid: Tuple[int, int, int]   # (nty, ntx, NT)

    @property
    def tile_rows(self) -> torch.Tensor:
        """[NT, M, 16]: one copied row per slot, for ``resolve_tiles``;
        ``rasterize`` reads the rows through ``all_faces`` instead."""
        return self.rows[self.all_faces.long()]


def xfm_points(points: torch.Tensor, mtx: torch.Tensor) -> torch.Tensor:
    """[N,3] points by a 4x4 matrix -> clip space [N,4] (row vectors)."""
    p = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    return p @ mtx.T


def _clamp_w(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w.abs() < 1e-8, 1e-8, w)


def _screen_xy(verts_clip: torch.Tensor, res: Tuple[int, int]):
    H, W = res
    w = _clamp_w(verts_clip[..., 3:4])
    ndc = verts_clip[..., :2] / w
    x = (ndc[..., 0] * 0.5 + 0.5) * W
    y = (0.5 - ndc[..., 1] * 0.5) * H
    return torch.stack([x, y], dim=-1)


def _edge_coeffs(pix_xy: torch.Tensor):
    """E_k(p) = A_k . p + C_k for edge k = corner k -> k+1."""
    v0 = pix_xy
    v1 = pix_xy[:, [1, 2, 0]]
    d = v1 - v0
    A = torch.stack([-d[..., 1], d[..., 0]], dim=-1)
    C = d[..., 1] * v0[..., 0] - d[..., 0] * v0[..., 1]
    return A, C


def _z_plane(pix_xy: torch.Tensor, z: torch.Tensor):
    """z/w affine over the screen: z(p) = az*x + bz*y + cz per face."""
    x, y = pix_xy[..., 0], pix_xy[..., 1]
    det = ((x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
           - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0]))
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    dz1, dz2 = z[:, 1] - z[:, 0], z[:, 2] - z[:, 0]
    az = (dz1 * (y[:, 2] - y[:, 0]) - dz2 * (y[:, 1] - y[:, 0])) / det
    bz = (dz2 * (x[:, 1] - x[:, 0]) - dz1 * (x[:, 2] - x[:, 0])) / det
    cz = z[:, 0] - az * x[:, 0] - bz * y[:, 0]
    return az, bz, cz


def bin_faces(verts_clip: torch.Tensor, faces: torch.Tensor,
              face_valid: torch.Tensor, resolution: Tuple[int, int],
              tile: Tuple[int, int] = (8, 128), max_faces_per_tile: int = 896,
              bin_expand: int = 8, max_global: int = 128) -> Binned:
    """Face setup + tile binning (``rasterize`` up to the resolve)."""
    verts_clip = verts_clip.detach()
    dev = verts_clip.device
    H, W = resolution
    th, tw = tile
    nty, ntx = -(-H // th), -(-W // tw)
    NT = nty * ntx
    F = faces.shape[0]
    if F >= (1 << 20) or NT >= (1 << 11):
        raise ValueError("pack format supports < 2^20 faces, < 2^11 tiles")
    faces_l = faces.long()

    tri = verts_clip[faces_l]                                   # [F, 3, 4]
    live = face_valid & (tri[..., 3] > 1e-6).all(dim=-1)
    pix_xy = _screen_xy(tri, resolution)
    zw = tri[..., 2] / _clamp_w(tri[..., 3])
    A, C = _edge_coeffs(pix_xy)
    az, bz, cz = _z_plane(pix_xy, zw)
    x, y = pix_xy[..., 0], pix_xy[..., 1]
    area = ((x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
            - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0]))
    live = live & (area.abs() > 1e-12)

    # ---- binning
    xmin, xmax = x.min(dim=1).values, x.max(dim=1).values
    ymin, ymax = y.min(dim=1).values, y.max(dim=1).values
    live = live & (xmax >= 0) & (xmin < W) & (ymax >= 0) & (ymin < H)

    def tcoord(v, tsize, n):
        return torch.clamp(torch.floor(v / tsize), 0, n - 1).to(torch.int32)

    tx0, tx1 = tcoord(xmin, tw, ntx), tcoord(xmax, tw, ntx)
    ty0, ty1 = tcoord(ymin, th, nty), tcoord(ymax, th, nty)
    sx = tx1 - tx0 + 1
    span = sx * (ty1 - ty0 + 1)
    small = live & (span <= bin_expand)
    big = live & (span > bin_expand)

    K = bin_expand
    k = torch.arange(K, dtype=torch.int32, device=dev)
    sxc = torch.clamp_min(sx, 1)[:, None]
    pair_tile = ((ty0[:, None] + torch.div(k[None, :], sxc,
                                           rounding_mode="floor")) * ntx
                 + (tx0[:, None] + k[None, :] % sxc))
    pair_ok = small[:, None] & (k[None, :] < span[:, None])
    pair_tile = torch.where(pair_ok, pair_tile, NT).to(torch.int32)
    # key (tile | nearest zq): within a tile the list is near-to-far, so an
    # overflowing tile drops its farthest faces; the stable sort carries
    # the face ids (pair p belongs to face p // K)
    zq = torch.clamp((zw.min(dim=1).values + 1.0) * (0.5 * ((1 << 20) - 1)),
                     0.0, float((1 << 20) - 1)).to(torch.int32)
    key = ((pair_tile << 20) | zq[:, None]).reshape(-1)
    s_key, order = torch.sort(key, stable=True)
    s_face = torch.div(order, K, rounding_mode="floor").to(torch.int32)
    s_tile = (s_key >> 20).contiguous()
    starts = torch.searchsorted(
        s_tile, torch.arange(NT + 1, dtype=torch.int32, device=dev))
    MFPT = max_faces_per_tile
    slot = torch.arange(MFPT, device=dev)
    gpos = starts[:NT, None] + slot[None, :]
    in_list = gpos < starts[1:, None]
    gpos = gpos.clamp(0, F * K - 1)
    tile_faces = torch.where(in_list, s_face[gpos], F)           # [NT, MFPT]
    counts = (starts[1:] - starts[:-1]).clamp(max=MFPT).to(torch.int32)

    # global (oversize) list, nearest first
    big_key = torch.where(big, zq, 1 << 30)
    big_idx = torch.argsort(big_key, stable=True)[:max_global]
    big_ok = big_key[big_idx] < (1 << 30)
    if big_idx.shape[0] < max_global:
        pad = max_global - big_idx.shape[0]
        big_idx = torch.cat([big_idx, torch.zeros(
            (pad,), dtype=big_idx.dtype, device=dev)])
        big_ok = torch.cat([big_ok, torch.zeros(
            (pad,), dtype=torch.bool, device=dev)])
    big_faces = torch.where(big_ok, big_idx.clamp(0, F - 1), F)

    all_faces = torch.cat([tile_faces,
                           big_faces.to(torch.int32)[None].expand(NT, -1)],
                          dim=1)
    pad = (-all_faces.shape[1]) % 128
    if pad:
        all_faces = torch.cat([all_faces, torch.full(
            (NT, pad), F, dtype=all_faces.dtype, device=dev)], dim=1)
    rows = pack_face_rows(A, C, az, bz, cz, live)
    rows = torch.cat([rows, torch.zeros((1, rows.shape[1]),
                                        dtype=rows.dtype, device=dev)])
    return Binned(rows=rows, all_faces=all_faces, counts=counts,
                  global_range=(MFPT, big_ok.sum().to(torch.int32)),
                  starts=starts, n_big=big.sum(), grid=(nty, ntx, NT))


def rasterize(verts_clip: torch.Tensor, faces: torch.Tensor,
              face_valid: torch.Tensor, resolution: Tuple[int, int],
              tile: Tuple[int, int] = (8, 128), max_faces_per_tile: int = 896,
              bin_expand: int = 8, max_global: int = 128, layers: int = 1):
    """Tile-binned z-buffer rasterization (hard visibility, no gradients).

    ``layers > 1`` depth-peels: layer k+1 is each pixel's nearest covering
    face whose key lies strictly above layer k's, so a pixel that misses
    in one layer misses in all later ones. Returns a tuple of ``Rast``
    near-to-far when ``layers > 1``, a single ``Rast`` otherwise."""
    H, W = resolution
    th, tw = tile
    b = bin_faces(verts_clip, faces, face_valid, resolution, tile,
                  max_faces_per_tile, bin_expand, max_global)
    nty, ntx, NT = b.grid
    tile_faces = b.all_faces.clamp(max=faces.shape[0] - 1)
    n_max_tile = (b.starts[1:] - b.starts[:-1]).max()

    def untile(x):
        return x.reshape(nty, ntx, th, tw).permute(0, 2, 1, 3).reshape(
            nty * th, ntx * tw)[:H, :W]

    rasts, keys = [], None
    for _ in range(layers):
        keys = resolve_tiles_indexed(b.rows, b.all_faces, tile, ntx,
                                     floor=keys, counts=b.counts,
                                     global_range=b.global_range)
        ids, zs = unpack_keys(keys, tile_faces)
        rasts.append(Rast(tri_id=untile(ids), zbuf=untile(zs),
                          n_max_tile=n_max_tile, n_big=b.n_big))
    return rasts[0] if layers == 1 else tuple(rasts)


BG_SENTINEL_Z = 3.4e38


def _resolve_tile(pix: torch.Tensor, face_ids: torch.Tensor, A, C, az, bz,
                  cz, live: torch.Tensor, block: int = 128,
                  floor_z: Optional[torch.Tensor] = None,
                  floor_id: Optional[torch.Tensor] = None):
    """Z-buffer of the pixel centres ``pix`` [P, 2] against every face of
    ``face_ids`` [M] (A [M, 3, 2], C [M, 3], az/bz/cz/live [M]), walked in
    blocks of ``block`` faces (JAX ``d3human_tpu/ops/rasterizer.py:112``).
    Within a block the least z wins, then the lowest slot (argmin); a
    later block wins only with a strictly smaller z. ``floor_z`` /
    ``floor_id`` [P] depth-peel: only candidates strictly after (floor_z,
    floor_id) in (z, id + 1) order compete. Returns (id + 1 [P] int32,
    0 = miss; z [P], ``BG_SENTINEL_Z`` at a miss)."""
    P, M = pix.shape[0], face_ids.shape[0]
    dev = pix.device
    block = min(block, M)
    nb = -(-M // block)
    pad = nb * block - M
    if pad:
        def pad0(x):
            return torch.cat([x, torch.zeros((pad,) + x.shape[1:],
                                             dtype=x.dtype, device=dev)])
        A, C, az, bz, cz, face_ids, live = map(
            pad0, (A, C, az, bz, cz, face_ids, live))
    best_z = torch.full((P,), BG_SENTINEL_Z, device=dev)
    best_id = torch.zeros((P,), dtype=torch.int32, device=dev)
    sent = torch.tensor(BG_SENTINEL_Z, device=dev)
    px, py = pix[:, 0:1], pix[:, 1:2]
    for s in range(0, nb * block, block):
        Ab, Cb = A[s:s + block], C[s:s + block]
        idb, liveb = face_ids[s:s + block], live[s:s + block]
        E = (pix @ Ab.reshape(-1, 2).T).reshape(P, block, 3) + Cb[None]
        inside = (E >= 0).all(-1) | (E <= 0).all(-1)
        z = px * az[None, s:s + block] + py * bz[None, s:s + block] \
            + cz[None, s:s + block]
        z = torch.where(inside & liveb[None], z, sent)
        if floor_z is not None:
            after = ((z > floor_z[:, None])
                     | ((z == floor_z[:, None])
                        & (idb[None, :] + 1 > floor_id[:, None])))
            z = torch.where(after, z, sent)
        zmin, arg = torch.min(z, dim=1)
        better = zmin < best_z
        best_z = torch.where(better, zmin, best_z)
        best_id = torch.where(better, (idb[arg] + 1).to(torch.int32),
                              best_id)
    return best_id, best_z


def rasterize_bruteforce(verts_clip: torch.Tensor, faces: torch.Tensor,
                         face_valid: torch.Tensor,
                         resolution: Tuple[int, int], layers: int = 1,
                         pixel_chunk: int = 1 << 18, cull: bool = True):
    """Oracle rasterizer (JAX ``d3human_tpu/ops/rasterizer.py:373``): every
    pixel tests every live face, no binning and no capacity. Pixels go
    through ``_resolve_tile`` ``pixel_chunk`` at a time, so the scratch is
    bounded ([pixel_chunk, 128, 3] edge values); the answer does not
    depend on the chunk. With ``cull`` (and more than one block of faces)
    a chunk tests only the live faces whose screen bounding box, grown by
    a pixel, meets the chunk's rows, in ascending id order: each pixel
    keeps the least (z, id) of the faces that cover it, so the answer is
    the same, ties included. ``layers > 1`` depth-peels with the
    (z, id + 1) floor and returns a tuple of ``Rast`` near to far. Plain
    PyTorch on every device (see the module docstring)."""
    verts_clip = verts_clip.detach()
    H, W = resolution
    dev = verts_clip.device
    tri = verts_clip[faces.long()]                               # [F, 3, 4]
    live = face_valid & (tri[..., 3] > 1e-6).all(dim=-1)
    pix_xy = _screen_xy(tri, resolution)
    zw = tri[..., 2] / _clamp_w(tri[..., 3])
    A, C = _edge_coeffs(pix_xy)
    az, bz, cz = _z_plane(pix_xy, zw)
    x, y = pix_xy[..., 0], pix_xy[..., 1]
    area = ((x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
            - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0]))
    live = live & (area.abs() > 1e-12)
    px, py = _pixel_centers(resolution, dev)
    pix = torch.stack([px.reshape(-1), py.reshape(-1)], dim=-1)
    all_ids = torch.arange(faces.shape[0], dtype=torch.int32, device=dev)
    cull = cull and faces.shape[0] > 128
    y_lo, y_hi = (y.amin(1), y.amax(1)) if cull else (None, None)
    chunks = []
    for s in range(0, H * W, pixel_chunk):
        e = min(s + pixel_chunk, H * W)
        if cull:
            # pixel centres of the chunk's rows lie in [s // W + 0.5,
            # (e - 1) // W + 0.5]
            keep = live & (y_lo <= (e - 1) // W + 1.5) \
                & (y_hi >= s // W - 0.5)
            sel = torch.nonzero(keep)[:, 0]
            chunks.append((s, e, all_ids[sel], A[sel], C[sel], az[sel],
                           bz[sel], cz[sel], live[sel]))
        else:
            chunks.append((s, e, all_ids, A, C, az, bz, cz, live))
    out, fz, fi = [], None, None
    for _ in range(layers):
        ids, zs = [], []
        for s, e, *faces_c in chunks:
            if faces_c[0].shape[0] == 0:
                ids.append(torch.zeros((e - s,), dtype=torch.int32,
                                       device=dev))
                zs.append(torch.full((e - s,), BG_SENTINEL_Z, device=dev))
                continue
            i_c, z_c = _resolve_tile(
                pix[s:e], *faces_c,
                floor_z=None if fz is None else fz[s:e],
                floor_id=None if fi is None else fi[s:e])
            ids.append(i_c)
            zs.append(z_c)
        ids, zs = torch.cat(ids), torch.cat(zs)
        out.append(Rast(tri_id=ids.reshape(H, W), zbuf=zs.reshape(H, W)))
        fz, fi = zs, ids
    return out[0] if layers == 1 else tuple(out)


# ---------------------------------------------------------------- dense

def _pixel_centers(resolution, device):
    """(x, y) pixel-centre coordinates, each [H, W]."""
    H, W = resolution
    y, x = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device) + 0.5,
        torch.arange(W, dtype=torch.float32, device=device) + 0.5,
        indexing="ij")
    return x, y


def barycentrics(verts_clip: torch.Tensor, faces: torch.Tensor, rast: Rast,
                 resolution):
    """Perspective-correct barycentrics [H, W, 3] (zero off the mesh) and
    the coverage mask [H, W]; differentiable in ``verts_clip``."""
    fid = torch.clamp_min(rast.tri_id - 1, 0)
    tri = verts_clip[faces[fid.long()].long()]                  # [H, W, 3, 4]
    px, py = _pixel_centers(resolution, verts_clip.device)
    bary = barycentrics_compact(tri, torch.stack([px, py], dim=-1),
                                resolution)
    mask = rast.tri_id > 0
    return torch.where(mask[..., None], bary,
                       torch.zeros((), device=bary.device)), mask


def interpolate(attrs: torch.Tensor, bary: torch.Tensor,
                faces: torch.Tensor, rast: Rast) -> torch.Tensor:
    """[V, C] vertex attributes -> [H, W, C], zero off the mesh."""
    fid = torch.clamp_min(rast.tri_id - 1, 0)
    fa = attrs[faces[fid.long()].long()]                        # [H, W, 3, C]
    out = (fa * bary[..., None]).sum(-2)
    return torch.where((rast.tri_id > 0)[..., None], out,
                       torch.zeros((), device=out.device))


def interpolate_face_attr(face_attrs: torch.Tensor,
                          rast: Rast) -> torch.Tensor:
    """Flat per-face attributes [F, C] -> [H, W, C], zero off the mesh."""
    fid = torch.clamp_min(rast.tri_id - 1, 0)
    return torch.where((rast.tri_id > 0)[..., None],
                       face_attrs[fid.long()],
                       torch.zeros((), device=face_attrs.device))


def avg_pool_nhwc(img: torch.Tensor, factor: int) -> torch.Tensor:
    if factor == 1:
        return img
    H, W, C = img.shape[-3:]
    x = img.reshape(*img.shape[:-3], H // factor, factor, W // factor,
                    factor, C)
    return x.mean(dim=(-4, -2))


# ---------------------------------------------------------------- compacted

def compact_cover(rast: Rast, max_cov: int):
    """Covered pixels compacted: (idx [P] sorted flat pixel ids, fill =
    npix; valid [P]; fid [P] face id, clamped to a valid face)."""
    flat = rast.tri_id.reshape(-1)
    npix = flat.shape[0]
    idx = first_k_indices(flat > 0, max_cov, npix)
    valid = idx < npix
    fid = torch.clamp_min(flat[idx.clamp(max=npix - 1).long()] - 1, 0)
    return idx, valid, fid


def pixel_centers_at(idx: torch.Tensor, resolution) -> torch.Tensor:
    """Flat pixel index -> (x + .5, y + .5) centres [P, 2]."""
    H, W = resolution
    x = (idx % W).float() + 0.5
    y = torch.div(idx, W, rounding_mode="floor").float() + 0.5
    return torch.stack([x, y], dim=-1)


def _degenerate_guard(bary: torch.Tensor) -> torch.Tensor:
    """Replace barycentrics with a component beyond +-2 (sliver-covered
    pixels) by their clamped renormalized convex version; healthy pixels
    are kept bit for bit."""
    bad = (bary.abs() > 2.0).any(dim=-1, keepdim=True)
    safe = bary.clamp(0.0, 1.0)
    safe = safe / torch.clamp_min(safe.sum(-1, keepdim=True), 1e-8)
    return torch.where(bad, safe, bary)


def _next(x: torch.Tensor) -> torch.Tensor:
    """x[..., [1, 2, 0]] of a corner triple as a roll, whose backward is a
    roll (an index's backward adds into zeros)."""
    return torch.roll(x, -1, -1)


def barycentrics_compact(tri_clip: torch.Tensor, pix_xy: torch.Tensor,
                         resolution) -> torch.Tensor:
    """Perspective-correct barycentrics [P, 3] from clip-space corners
    [P, 3, 4] at pixel centres [P, 2] (differentiable in tri_clip)."""
    H, W = resolution
    w = _clamp_w(tri_clip[..., 3])
    xs = (tri_clip[..., 0] / w * 0.5 + 0.5) * W
    ys = (0.5 - tri_clip[..., 1] / w * 0.5) * H
    px, py = pix_xy[..., 0:1], pix_xy[..., 1:2]
    # edge k at the pixel; b_k is opposite edge k -> edges (1, 2, 0)
    e = ((_next(xs) - xs) * (py - ys) - (_next(ys) - ys) * (px - xs))
    bs_num = _next(e)
    ssum = bs_num[..., 0] + bs_num[..., 1] + bs_num[..., 2]
    ssum = torch.where(ssum.abs() < 1e-12, 1e-12, ssum)
    bw = bs_num / ssum[..., None] / w
    bsum = bw.sum(-1, keepdim=True)
    bsum = torch.where(bsum.abs() < 1e-12, 1e-12, bsum)
    return _degenerate_guard(bw / bsum)


def scatter_image(vals: torch.Tensor, idx: torch.Tensor, resolution):
    """[P, C] compacted values -> [H, W, C] image, zeros elsewhere (idx is
    sorted and unique; the fill rows are dropped)."""
    H, W = resolution
    return scatter_rows_sorted(vals, idx, H * W).reshape(H, W, vals.shape[-1])


def aa_pair_candidates(rast: Rast, axis: int, z_thresh: float):
    """Silhouette pair mask along ``axis``: ids differ and (coverage changes
    or the depth jumps by more than z_thresh relative)."""
    idm, zb = rast.tri_id, rast.zbuf
    if axis == 1:
        ida, idb, za, zb_ = idm[:, :-1], idm[:, 1:], zb[:, :-1], zb[:, 1:]
    else:
        ida, idb, za, zb_ = idm[:-1, :], idm[1:, :], zb[:-1, :], zb[1:, :]
    a_cov, b_cov = ida > 0, idb > 0
    zjump = (za - zb_).abs() > z_thresh * (za.abs() + zb_.abs() + 1e-3)
    return (ida != idb) & (a_cov | b_cov) & ((a_cov != b_cov) | zjump)


def aa_pairs_compact(rast: Rast, resolution, axis: int, max_pairs: int,
                     z_thresh: float = 0.01):
    """(pidx [Q] flat index into the pair grid, valid [Q], n_candidates)."""
    flat = aa_pair_candidates(rast, axis, z_thresh).reshape(-1)
    n = flat.shape[0]
    pidx = first_k_indices(flat, max_pairs, n)
    return pidx, pidx < n, flat.sum()


def aa_geometry_compact(verts_clip, faces, rast: Rast, pidx, pvalid,
                        resolution, axis: int):
    """Per-pair AA blend geometry. Returns (ia, ib, a_wins, spill, recede);
    ia/ib flat full-image pixel indices (may be out of range for fill)."""
    H, W = resolution
    pw = W - 1 if axis == 1 else W
    pidx = pidx.long()
    prow = torch.div(pidx, pw, rounding_mode="floor")
    pcol = pidx % pw
    ia = prow * W + pcol
    ib = ia + 1 if axis == 1 else ia + W
    n = H * W
    ia_c, ib_c = ia.clamp(max=n - 1), ib.clamp(max=n - 1)
    idm = rast.tri_id.reshape(-1)
    zbf = rast.zbuf.reshape(-1)
    ida, idb = idm[ia_c], idm[ib_c]
    za, zb_ = zbf[ia_c], zbf[ib_c]
    a_cov, b_cov = ida > 0, idb > 0
    a_wins = a_cov & ((~b_cov) | (za <= zb_))
    fid = torch.clamp_min(torch.where(a_wins, ida, idb) - 1, 0)
    tri = gather_rows(verts_clip, faces[fid.long()])            # [Q, 3, 4]
    w = _clamp_w(tri[..., 3])
    xs = (tri[..., 0] / w * 0.5 + 0.5) * W
    ys = (0.5 - tri[..., 1] / w * 0.5) * H

    def centre(i):
        return ((i % W).float() + 0.5,
                torch.div(i, W, rounding_mode="floor").float() + 0.5)

    (pax, pay), (pbx, pby) = centre(ia_c), centre(ib_c)

    def edges_at(qx, qy):
        return ((_next(xs) - xs) * (qy[..., None] - ys)
                - (_next(ys) - ys) * (qx[..., None] - xs))     # [Q, 3]

    Ea, Eb = edges_at(pax, pay), edges_at(pbx, pby)
    sgn = torch.where(Ea.sum(-1, keepdim=True) + Eb.sum(-1, keepdim=True)
                      >= 0, 1.0, -1.0)
    aw = a_wins[..., None]
    Ew = torch.where(aw, Ea, Eb) * sgn
    Eo = torch.where(aw, Eb, Ea) * sgn
    ex = (_next(xs) - xs).abs()
    ey = (_next(ys) - ys).abs()
    owns = (ey >= ex) if axis == 1 else (ex > ey)
    flips = (Ew > 0) & (Eo < 0) & owns
    denom = Ew - Eo
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    t = torch.where(flips, Ew / denom, 2.0).min(dim=-1).values
    active = pvalid & flips.any(dim=-1) & (t <= 1.0)
    zero = torch.zeros((), device=t.device)
    spill = torch.where(active, torch.clamp(t - 0.5, 0.0, 0.5), zero)
    recede = torch.where(active, torch.clamp(0.5 - t, 0.0, 0.5), zero)
    return ia, ib, a_wins, spill, recede


def apply_aa_sparse(img: torch.Tensor, pairs) -> torch.Tensor:
    """Apply the compacted AA blend deltas (one entry of ``pairs`` per
    axis) to a [H, W, C] image; out-of-range pair pixels are dropped. The
    pair colours are one ``gather_rows`` and the deltas one
    ``segment_add_rows`` an axis, so the backward adds in the scatter's
    fixed order (no float atomics, no hot row)."""
    H, W, C = img.shape
    n = H * W
    flat = torch.cat([img.reshape(n, C),
                      torch.zeros((1, C), dtype=img.dtype,
                                  device=img.device)])  # row n absorbs drops
    for (ia, ib, a_wins, spill, recede) in pairs:
        q = ia.shape[0]
        cab = gather_rows(flat, torch.cat([ia, ib]).clamp(max=n - 1))
        ca, cb = cab[:q], cab[q:]
        aw = a_wins[..., None]
        wcol = torch.where(aw, ca, cb)
        lcol = torch.where(aw, cb, ca)
        d_l = (wcol - lcol) * spill[..., None]
        d_w = (lcol - wcol) * recede[..., None]
        d_a = torch.where(aw, d_w, d_l)
        d_b = torch.where(aw, d_l, d_w)
        dest = torch.cat([torch.where(ia < n, ia, n),
                          torch.where(ib < n, ib, n)])
        flat = flat + segment_add_rows(torch.cat([d_a, d_b]), dest, n + 1)
    return flat[:n].reshape(H, W, C)


def aa_weights(verts_clip: torch.Tensor, faces: torch.Tensor, rast: Rast,
               resolution):
    """Dense AA blend geometry for both pair directions: every neighbour
    pair whose ids differ and of which one is covered goes through the
    pair geometry of ``aa_geometry_compact``. Per axis (1, then 0):
    (a_wins, spill, recede), each [H, W-1, 1] or [H-1, W, 1]."""
    H, W = resolution
    out = []
    for axis in (1, 0):
        idm = rast.tri_id
        ida, idb = ((idm[:, :-1], idm[:, 1:]) if axis == 1
                    else (idm[:-1, :], idm[1:, :]))
        pvalid = ((ida != idb) & ((ida > 0) | (idb > 0))).reshape(-1)
        pidx = torch.arange(pvalid.shape[0], device=pvalid.device)
        _, _, a_wins, spill, recede = aa_geometry_compact(
            verts_clip, faces, rast, pidx, pvalid, resolution, axis)
        shape = (*ida.shape, 1)
        out.append((a_wins.reshape(shape), spill.reshape(shape),
                    recede.reshape(shape)))
    return tuple(out)


def apply_aa(color: torch.Tensor, weights) -> torch.Tensor:
    """Blend one [H, W, C] buffer with dense AA weights (both directions);
    a pixel accumulates the corrections of all its pairs."""
    for axis, (a_wins, spill, recede) in zip((1, 0), weights):
        ca, cb = ((color[:, :-1], color[:, 1:]) if axis == 1
                  else (color[:-1, :], color[1:, :]))
        wcol = torch.where(a_wins, ca, cb)
        lcol = torch.where(a_wins, cb, ca)
        d_l = (wcol - lcol) * spill
        d_w = (lcol - wcol) * recede
        d_a = torch.where(a_wins, d_w, d_l)
        d_b = torch.where(a_wins, d_l, d_w)
        pad_a = (0, 0, 0, 1) if axis == 1 else (0, 0, 0, 0, 0, 1)
        pad_b = (0, 0, 1, 0) if axis == 1 else (0, 0, 0, 0, 1, 0)
        color = color + (torch.nn.functional.pad(d_a, pad_a)
                         + torch.nn.functional.pad(d_b, pad_b))
    return color


def antialias(color: torch.Tensor, verts_clip: torch.Tensor,
              faces: torch.Tensor, rast: Rast) -> torch.Tensor:
    """Silhouette antialiasing of one [H, W, C] buffer: the dense AA
    geometry of ``rast`` (``aa_weights``) applied by ``apply_aa``."""
    return apply_aa(color, aa_weights(verts_clip, faces, rast,
                                      color.shape[:2]))


def visible_face_mask(rast: Rast, n_faces: int) -> torch.Tensor:
    """Boolean [F] mask of faces visible in the rasterization: a count of
    the per-pixel ids through the sorted-COO scatter."""
    ids = rast.tri_id.reshape(-1)
    cnt = coo_scatter_add(ids, torch.ones((ids.shape[0], 1),
                                          device=ids.device), n_faces + 1)
    return cnt[1:, 0] > 0
