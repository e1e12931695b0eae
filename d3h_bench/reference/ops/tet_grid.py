"""Kuhn-lattice tet grid: static topology built in numpy.

Counterpart of ``d3human_tpu/ops/tet_grid.py``: 6 tets per cube sharing the
main diagonal, unique edges stored class-major over 7 direction classes
(so an edge id is pure arithmetic), ``edges`` padded with row E = (0, 0),
and the crop to a box around the canonical template. The arrays equal the
JAX package's exactly; here they become torch tensors on ``device``. The
lattice can be cached in an npz that both packages read.

``load_reference_tet_grid`` reads the reference's own grid file
(``{vertices, indices}``, as ``data/tets/tet_grid.npz``): its topology is
unstructured (``dims`` None), its unique edges come from a sort, and the
G-Shell extraction and ``sdf_reg_loss`` take their gather branches.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

TET_EDGES_LOCAL = np.asarray(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)

KUHN_PATHS = (
    ((0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)),
    ((0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)),
    ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)),
)

EDGE_CLASSES = ((1, 0, 0), (0, 1, 0), (0, 0, 1),
                (1, 1, 0), (0, 1, 1), (1, 0, 1), (1, 1, 1))


@dataclasses.dataclass(frozen=True)
class TetGrid:
    verts: torch.Tensor       # [N, 3] f32 lattice positions (transformed)
    tets: torch.Tensor        # [T, 4] i32 (cell-major, 6 per cell)
    edges: torch.Tensor       # [E+1, 2] i32 class-major; row E = (0, 0)
    tet_edges: torch.Tensor   # [T, 6] i32 edge ids per tet
    # cells per axis of a lattice; None for an unstructured grid
    dims: Optional[Tuple[int, int, int]] = None

    @property
    def n_verts(self) -> int:
        return self.verts.shape[0]

    @property
    def n_tets(self) -> int:
        return self.tets.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edges.shape[0] - 1

    @property
    def vert_dims(self) -> Optional[Tuple[int, int, int]]:
        if self.dims is None:
            return None
        return tuple(d + 1 for d in self.dims)


def _class_shapes(dims):
    vx, vy, vz = dims[0] + 1, dims[1] + 1, dims[2] + 1
    return [(vx - d[0], vy - d[1], vz - d[2]) for d in EDGE_CLASSES]


def class_offsets(dims):
    shapes = _class_shapes(dims)
    sizes = [int(np.prod(s)) for s in shapes]
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    return offsets, shapes, sizes


def structured_topology(dims):
    """(edges [E,2], tets [T,4], tet_edges [T,6]) by index arithmetic."""
    rx, ry, rz = dims
    vy, vz = ry + 1, rz + 1

    def vid(ix, iy, iz):
        return (ix * vy + iy) * vz + iz

    offsets, shapes, _ = class_offsets(dims)
    E = offsets[-1]
    edges = np.empty((E, 2), np.int64)
    for c, (d, shape) in enumerate(zip(EDGE_CLASSES, shapes)):
        bx, by, bz = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                                 np.arange(shape[2]), indexing="ij")
        edges[offsets[c]:offsets[c + 1], 0] = vid(bx, by, bz).ravel()
        edges[offsets[c]:offsets[c + 1], 1] = vid(
            bx + d[0], by + d[1], bz + d[2]).ravel()

    cx, cy, cz = np.meshgrid(np.arange(rx), np.arange(ry), np.arange(rz),
                             indexing="ij")
    cx, cy, cz = cx.ravel(), cy.ravel(), cz.ravel()
    NC = len(cx)
    tets = np.empty((NC * 6, 4), np.int64)
    tet_edges = np.empty((NC * 6, 6), np.int64)
    class_index = {d: i for i, d in enumerate(EDGE_CLASSES)}
    for k, path in enumerate(KUHN_PATHS):
        for ci, p in enumerate(path):
            tets[k::6, ci] = vid(cx + p[0], cy + p[1], cz + p[2])
        for ei, (a, b) in enumerate(TET_EDGES_LOCAL):
            u, v = path[a], path[b]
            c = class_index[(v[0] - u[0], v[1] - u[1], v[2] - u[2])]
            shape = shapes[c]
            base = ((cx + u[0]) * shape[1] + (cy + u[1])) * shape[2] \
                + (cz + u[2])
            tet_edges[k::6, ei] = offsets[c] + base
    return edges, tets, tet_edges


def tet_type_corner_offsets():
    """The corner offsets of the 6 tet types of a cell (``KUHN_PATHS``)."""
    return KUHN_PATHS


def crop_window(res3, bounds, y_offset, scale, crop_box):
    """Per-axis vertex-index windows [i0, i1] of the full lattice covering
    ``crop_box`` (final world coords), clamped to the lattice."""
    lo = np.asarray(crop_box[0], np.float64)
    hi = np.asarray(crop_box[1], np.float64)
    windows = []
    for ax in range(3):
        n = res3[ax] + 1
        w = np.linspace(bounds[0][ax], bounds[1][ax], n,
                        dtype=np.float32).astype(np.float64)
        if ax == 1:
            w = w + y_offset
        w = w * scale
        i0 = int(np.searchsorted(w, lo[ax], side="right") - 1)
        i1 = int(np.searchsorted(w, hi[ax], side="left"))
        i0, i1 = max(0, i0), min(n - 1, i1)
        if i1 - i0 < 1:
            raise ValueError(f"crop_box axis {ax} covers no lattice cell")
        windows.append((i0, i1))
    return windows


def make_tet_grid(res=128, bounds=((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5)),
                  y_offset: float = -0.1919, scale: float = 1.2,
                  crop_box=None, device="cuda",
                  cache_path: Optional[str] = None) -> TetGrid:
    """The lattice with the reference transforms (verts[:,1] += y_offset;
    verts *= scale), optionally cropped to ``crop_box`` by slicing the full
    per-axis linspaces (so kept vertices are a bitwise subset).

    ``cache_path``: an npz of the lattice in the JAX package's layout
    (verts, tets, edges, tet_edges, dims and ``meta``, which holds every
    input beyond the file name); read when its meta matches, else built
    and written."""
    res3 = (res, res, res) if isinstance(res, int) else tuple(res)
    cb = ([np.nan] * 6 if crop_box is None
          else list(crop_box[0]) + list(crop_box[1]))
    meta = np.asarray([y_offset, scale,
                       *np.asarray(bounds, np.float64).ravel(), *cb, *res3],
                      np.float64)
    cached = None
    if cache_path is not None and os.path.exists(cache_path):
        with np.load(cache_path) as z:
            if "meta" in z and z["meta"].shape == meta.shape \
                    and np.array_equal(z["meta"], meta, equal_nan=True):
                cached = {k: z[k] for k in ("verts", "tets", "edges",
                                            "tet_edges", "dims")}
            else:
                print(f"[tet_grid] stale cache {cache_path} (meta "
                      "mismatch): rebuilding", flush=True)
    if cached is not None:
        verts, tets, edges, tet_edges = (cached["verts"], cached["tets"],
                                         cached["edges"], cached["tet_edges"])
        res3 = tuple(int(d) for d in cached["dims"])
    else:
        if crop_box is not None:
            win = crop_window(res3, bounds, y_offset, scale, crop_box)
            axes = []
            for ax, (i0, i1) in enumerate(win):
                full = np.linspace(bounds[0][ax], bounds[1][ax],
                                   res3[ax] + 1, dtype=np.float32)
                axes.append(full[i0:i1 + 1])
            res3 = tuple(i1 - i0 for i0, i1 in win)
        else:
            axes = [np.linspace(bounds[0][ax], bounds[1][ax], res3[ax] + 1,
                                dtype=np.float32) for ax in range(3)]
        gx, gy, gz = np.meshgrid(*axes, indexing="ij")
        verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
        verts[:, 1] += y_offset
        verts *= scale
        edges, tets, tet_edges = structured_topology(res3)
        if cache_path is not None:
            # written aside and renamed, so a concurrent or killed run never
            # leaves a reader half a file
            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            tmp = f"{cache_path}.tmp.npz"
            np.savez(tmp, verts=verts, tets=tets, edges=edges,
                     tet_edges=tet_edges, dims=np.asarray(res3), meta=meta)
            os.replace(tmp, cache_path)
    return _grid_tensors(verts, tets, edges, tet_edges, res3, device)


def _grid_tensors(verts, tets, edges, tet_edges, dims, device) -> TetGrid:
    """The host arrays as a TetGrid on ``device``, ``edges`` padded with
    row E = (0, 0)."""
    edges = np.concatenate([edges, np.zeros((1, 2), edges.dtype)], axis=0)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    return TetGrid(verts=t(verts, torch.float32), tets=t(tets, torch.int32),
                   edges=t(edges, torch.int32),
                   tet_edges=t(tet_edges, torch.int32), dims=dims)


def _unique_edges_generic(tets: np.ndarray):
    """(edges [E, 2] int64 sorted by (e0, e1) with e0 < e1, tet_edges
    [T, 6] int64) of any tet soup: int64 keys ``e0 << 32 | e1`` and
    ``np.unique``."""
    e = tets[:, TET_EDGES_LOCAL]
    e = np.sort(e, axis=-1).reshape(-1, 2)
    key = e[:, 0].astype(np.int64) << 32 | e[:, 1].astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    edges = np.stack([uniq >> 32, uniq & 0xFFFFFFFF], axis=-1)
    return edges.astype(np.int64), inv.reshape(-1, 6)


# the reference's grid transform (ref geometry/hmsdf.py:210-211)
REF_Y_OFFSET = -0.1919
REF_SCALE = 1.2


def load_reference_tet_grid(npz_path: str, device="cuda") -> TetGrid:
    """A reference-format tet grid npz ({vertices, indices}) with the
    reference's transform (y + REF_Y_OFFSET, then x REF_SCALE, in float32)
    and unique edges sorted by ``e0 << 32 | e1`` (``torch.unique`` on
    ``device``); ``dims`` None."""
    with np.load(npz_path) as z:
        verts = np.asarray(z["vertices"], np.float32)
        tets = np.asarray(z["indices"], np.int64)
    verts[:, 1] += REF_Y_OFFSET
    verts *= REF_SCALE
    t = torch.as_tensor(tets, device=device)
    e = torch.sort(t[:, torch.as_tensor(TET_EDGES_LOCAL, device=device)],
                   dim=-1).values.reshape(-1, 2)
    key = (e[:, 0] << 32) | e[:, 1]
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    del e, key
    edges = torch.stack([uniq >> 32, uniq & 0xFFFFFFFF], dim=-1)
    edges = torch.cat([edges, torch.zeros((1, 2), dtype=edges.dtype,
                                          device=device)])
    return TetGrid(verts=torch.as_tensor(verts, device=device),
                   tets=t.to(torch.int32), edges=edges.to(torch.int32),
                   tet_edges=inv.reshape(-1, 6).to(torch.int32), dims=None)


def save_reference_tet_grid(npz_path: str, verts, tets) -> None:
    """Write transformed ``verts`` [N, 3] and ``tets`` [T, 4] as a
    reference-format npz: ``vertices`` = verts / REF_SCALE with y -
    REF_Y_OFFSET (in float64, stored float32), ``indices`` int64. Read back
    by ``load_reference_tet_grid``, positions move by float32 rounding."""
    v = np.asarray(verts, np.float64) / REF_SCALE
    v[:, 1] -= REF_Y_OFFSET
    os.makedirs(os.path.dirname(npz_path) or ".", exist_ok=True)
    np.savez(npz_path, vertices=v.astype(np.float32),
             indices=np.asarray(tets, np.int64))


def unstructured(grid: TetGrid) -> TetGrid:
    """``grid``'s verts and tets as an unstructured grid (``dims`` None):
    edges and tet edges from ``_unique_edges_generic``, so against a
    lattice only the edge order differs."""
    edges, tet_edges = _unique_edges_generic(
        grid.tets.cpu().numpy().astype(np.int64))
    edges = np.concatenate([edges, np.zeros((1, 2), edges.dtype)], axis=0)
    dev = grid.verts.device
    return TetGrid(verts=grid.verts, tets=grid.tets,
                   edges=torch.as_tensor(edges).to(dev, torch.int32),
                   tet_edges=torch.as_tensor(tet_edges).to(dev, torch.int32))


def template_crop_box(template_verts: np.ndarray, margin: float):
    """((lo3), (hi3)): the template's bbox grown by ``margin``."""
    v = np.asarray(template_verts)
    return tuple(v.min(0) - margin), tuple(v.max(0) + margin)
