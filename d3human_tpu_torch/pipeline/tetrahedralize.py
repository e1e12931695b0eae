"""Body-fitted tetrahedral meshes from a surface, on the host (the port's
own copy of ``d3human_tpu/pipeline/tetrahedralize.py``, on the port's
native mesh-SDF engine and tet lattice):

* :func:`tetrahedralize_delaunay`: an unstructured body-conforming
  Delaunay mesh with TetGen-style volume refinement (surface samples and a
  jittered interior lattice, scipy's Delaunay, inside tets kept by the
  mesh SDF's sign, circumcentres of oversized tets inserted until the
  ``max_volume`` bound holds); ``get_tet_mesh`` writes its ``{v, f}`` npz;
* :func:`tetrahedralize_interior`: the crust of the regular Kuhn lattice
  (tets inside the surface or within a band of it).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from d3human_tpu_torch.ops.mesh_sdf import mesh_sdf_host
from d3human_tpu_torch.ops.tet_grid import make_tet_grid


def tetrahedralize_interior(
    verts: np.ndarray, faces: np.ndarray,
    grid_res: int = 48, band: float = 0.02, margin: float = 0.05,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (tet_verts [N,3], tets [T,4]) covering the interior + band."""
    lo = verts.min(axis=0) - margin
    hi = verts.max(axis=0) + margin
    grid = make_tet_grid(res=grid_res, bounds=(tuple(lo), tuple(hi)),
                         y_offset=0.0, scale=1.0, device="cpu")
    gverts = grid.verts.numpy()
    sdf = mesh_sdf_host(gverts, verts, faces, sign_convention="pos_inside")

    keep_vert = sdf > -band          # inside or within the band
    tets = grid.tets.numpy()
    keep_tet = keep_vert[tets].any(axis=1)
    tets = tets[keep_tet]

    used, inv = np.unique(tets.reshape(-1), return_inverse=True)
    tet_verts = gverts[used]
    return tet_verts.astype(np.float32), inv.reshape(-1, 4).astype(np.int64)


# ---------------------------------------------------------------------------
# Unstructured Delaunay mesher (TetGen get_tet_mesh parity)
# ---------------------------------------------------------------------------

def _tet_volumes(v: np.ndarray, t: np.ndarray) -> np.ndarray:
    a, b, c, d = (v[t[:, i]] for i in range(4))
    return np.abs(np.einsum("ij,ij->i", np.cross(b - a, c - a), d - a)) / 6.0


def _circumcenters(v: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Circumcenter of each tet (Shewchuk refinement point). Solves
    2 (P_i - P_0) . x = |P_i|^2 - |P_0|^2 per tet; singular (degenerate)
    tets fall back to the centroid."""
    p0 = v[t[:, 0]]
    rows = np.stack([v[t[:, i]] - p0 for i in (1, 2, 3)], axis=1)   # [T,3,3]
    # (P_i - P_0) . (P_i + P_0) = |P_i|^2 - |P_0|^2
    rhs = 0.5 * np.stack(
        [np.einsum("ij,ij->i", v[t[:, i]] - p0, v[t[:, i]] + p0)
         for i in (1, 2, 3)], axis=1)
    out = np.empty_like(p0)
    det = np.linalg.det(rows)
    ok = np.abs(det) > 1e-14
    if ok.any():
        out[ok] = np.linalg.solve(rows[ok], rhs[ok][..., None])[..., 0]
    if (~ok).any():
        out[~ok] = v[t[~ok]].mean(axis=1)
    return out


def _dedup_voxel(points: np.ndarray, h: float) -> np.ndarray:
    """Keep one point per h-voxel (first wins) — cheap blue-noise-ish
    decimation for the surface sample set."""
    key = np.floor(points / h).astype(np.int64)
    _, idx = np.unique(key, axis=0, return_index=True)
    return points[np.sort(idx)]


def tetrahedralize_delaunay(
    verts: np.ndarray, faces: np.ndarray,
    max_volume: float = 6e-3, refine_iters: int = 3,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Body-conforming unstructured tet mesh with a volume bound.

    TetGen-quality-loop equivalent (ref get_tet_smpl.py:12-19:
    ``tetrahedralize(fixedvolume=1, maxvolume=6e-3, ...)``): Delaunay of
    surface + interior samples, inside-filtering by the exact mesh SDF,
    then Shewchuk-style refinement — insert the circumcenter of every
    kept tet whose volume exceeds ``max_volume`` and re-triangulate.

    Returns ``(tet_verts [N,3] float32, tets [T,4] int64)``; every
    returned tet's centroid is strictly inside the input surface.
    """
    from scipy.spatial import Delaunay

    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    # regular-tet edge for the target volume: V = a^3 / (6 sqrt 2)
    edge = float((max_volume * 6.0 * np.sqrt(2.0)) ** (1.0 / 3.0))

    surf = _dedup_voxel(verts, 0.7 * edge)

    lo = verts.min(axis=0) - 0.5 * edge
    hi = verts.max(axis=0) + 0.5 * edge
    axes = [np.arange(lo[k], hi[k] + edge, edge) for k in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    lattice = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    rng = np.random.RandomState(seed)
    lattice = lattice + rng.uniform(-0.05 * edge, 0.05 * edge,
                                    lattice.shape)
    # strictly interior by half an edge: near-surface volume is carried by
    # the surface samples, which kills boundary slivers
    sd = mesh_sdf_host(lattice, verts, faces, sign_convention="pos_inside")
    interior = lattice[sd > 0.5 * edge]

    points = np.concatenate([surf, interior], axis=0)

    def _inside_tets(pts, simplices):
        cen = pts[simplices].mean(axis=1)
        s = mesh_sdf_host(cen, verts, faces, sign_convention="pos_inside")
        return simplices[s > 0.0]

    tri = Delaunay(points)
    tets = _inside_tets(points, tri.simplices)
    for _ in range(refine_iters):
        vol = _tet_volumes(points, tets)
        big = tets[vol > max_volume]
        if len(big) == 0:
            break
        cand = _circumcenters(points, big)
        s = mesh_sdf_host(cand, verts, faces, sign_convention="pos_inside")
        cen = points[big].mean(axis=1)
        cand = np.where((s > 0.0)[:, None], cand, cen)   # clip to interior
        points = np.concatenate([points, cand], axis=0)
        tri = Delaunay(points)
        tets = _inside_tets(points, tri.simplices)

    used, inv = np.unique(tets.reshape(-1), return_inverse=True)
    return (points[used].astype(np.float32),
            inv.reshape(-1, 4).astype(np.int64))


def get_tet_mesh(mesh_path: str, save_npz_path: str,
                 max_volume: float = 6e-3):
    """File-level parity with ref get_tet_smpl.py:get_tet_mesh — load a
    surface mesh, tetrahedralize the interior, save ``{v, f}`` npz (plus
    the same sibling .obj dump of tets-as-quads the reference writes)."""
    from d3human_tpu_torch.utils.io import load_obj

    v, f = load_obj(mesh_path)
    tv, tt = tetrahedralize_delaunay(np.asarray(v), np.asarray(f),
                                     max_volume=max_volume)
    np.savez(save_npz_path, v=tv, f=tt)
    obj_path = save_npz_path.replace("npz", "obj")
    with open(obj_path, "w") as fh:
        for p in tv:
            fh.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for t in tt:
            fh.write(f"f {t[0]+1} {t[1]+1} {t[2]+1} {t[3]+1}\n")
    return tv, tt
