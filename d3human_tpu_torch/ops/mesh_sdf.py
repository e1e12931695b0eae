"""Signed distance to a triangle mesh (counterpart of
``d3human_tpu/ops/mesh_sdf.py``).

``mesh_sdf`` is the tensor op: a K=8 search to the face centroids prunes
the faces, exact point-triangle distances over the candidates pick the
nearest, and the sign comes from that face's normal. It runs in
``block``-point chunks, since the [P, k, 3, 3] candidates take ~290 bytes
a point. ``mesh_sdf_host`` is the host entry point of the template
surgery: numpy in and out, answered by the native engine
(``native/meshsdf.py``, exact BVH closest point + pseudonormal sign). Only
when that engine cannot be built or loaded does it answer with
``mesh_sdf`` on ``device``; it says so on stderr, and ``ENGINE_COUNTS``
counts which engine answered each call.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from d3human_tpu_torch.ops.knn import knn

# host queries answered by each engine since the counts were last reset
ENGINE_COUNTS = {"native": 0, "device": 0}


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _point_triangle(p: torch.Tensor, a, b, c):
    """Closest point on triangle (a, b, c) to p, all [..., 3]. Returns
    (closest_point, sq_dist)."""
    ab, ac = b - a, c - a
    ap, bp, cp = p - a, p - b, p - c
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    d5, d6 = _dot(ab, cp), _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp_min(va + vb + vc, 1e-20)
    v, w = vb / denom, vc / denom
    interior = a + ab * v[..., None] + ac * w[..., None]

    # edge and vertex regions
    t_ab = torch.clamp(d1 / torch.clamp_min(d1 - d3, 1e-20), 0, 1)
    on_ab = a + ab * t_ab[..., None]
    t_ac = torch.clamp(d2 / torch.clamp_min(d2 - d6, 1e-20), 0, 1)
    on_ac = a + ac * t_ac[..., None]
    t_bc = torch.clamp((d4 - d3) / torch.clamp_min((d4 - d3) + (d5 - d6),
                                                   1e-20), 0, 1)
    on_bc = b + (c - b) * t_bc[..., None]

    cand = interior
    for cond, pt in (((d1 <= 0) & (d2 <= 0), a),
                     ((d3 >= 0) & (d4 <= d3), b),
                     ((d6 >= 0) & (d5 <= d6), c),
                     ((vc <= 0) & (d1 >= 0) & (d3 <= 0), on_ab),
                     ((vb <= 0) & (d2 >= 0) & (d6 <= 0), on_ac),
                     ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0), on_bc)):
        cand = torch.where(cond[..., None], pt, cand)
    return cand, ((p - cand) ** 2).sum(-1)


def face_centroids(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """The mean of each face's corners as XLA computes it: the sum times
    the reciprocal of 3."""
    tri = verts[faces.long()]
    return (tri[:, 0] + tri[:, 1] + tri[:, 2]) * (1.0 / 3.0)


def _mesh_sdf_block(points, verts, faces, centroids, k, sign_convention):
    faces = faces.long()
    _, idx = knn(points, centroids, k=k)                  # [P, k]
    tri = verts[faces[idx]]                               # [P, k, 3, 3]
    closest, sq = _point_triangle(points[:, None, :], tri[..., 0, :],
                                  tri[..., 1, :], tri[..., 2, :])
    best = torch.argmin(sq, dim=1, keepdim=True)          # [P, 1]
    d = torch.sqrt(torch.gather(sq, 1, best)[:, 0] + 1e-20)
    cp = torch.gather(closest, 1, best[..., None].expand(-1, 1, 3))[:, 0]
    tri_n = verts[faces[torch.gather(idx, 1, best)[:, 0]]]
    n = torch.linalg.cross(tri_n[:, 1] - tri_n[:, 0],
                           tri_n[:, 2] - tri_n[:, 0], dim=-1)
    inside = _dot(n, points - cp) < 0
    signed = torch.where(inside, -d, d)
    return -signed if sign_convention == "pos_inside" else signed


def mesh_sdf(points: torch.Tensor, verts: torch.Tensor, faces: torch.Tensor,
             k: int = 8, sign_convention: str = "neg_inside",
             block: int = 131072) -> torch.Tensor:
    """Signed distance [P] from points [P, 3] to the mesh, negative inside
    (``pos_inside``: positive inside, the reference's convention for the
    SDF target), in chunks of ``block`` points."""
    centroids = face_centroids(verts, faces)
    return torch.cat([
        _mesh_sdf_block(points[s:s + block], verts, faces, centroids, k,
                        sign_convention)
        for s in range(0, points.shape[0], block)])


def mesh_sdf_host(points, verts, faces, sign_convention: str = "neg_inside",
                  device="cuda") -> np.ndarray:
    """Signed distance on the host (numpy in and out) by the native
    engine; by ``mesh_sdf`` on ``device`` only when the engine cannot be
    built or loaded. An error inside a query is raised, not answered
    another way."""
    from d3human_tpu_torch.native import BuildError
    from d3human_tpu_torch.native.meshsdf import MeshSDF

    try:
        engine = MeshSDF(np.asarray(verts), np.asarray(faces))
    except BuildError as e:
        print(f"mesh_sdf_host: the native engine is unavailable ({e}); "
              f"answering with the tensor op on {device}", file=sys.stderr,
              flush=True)
        ENGINE_COUNTS["device"] += 1

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

        with torch.no_grad():
            out = mesh_sdf(t(points, torch.float32), t(verts, torch.float32),
                           t(faces, torch.int64), k=8,
                           sign_convention=sign_convention)
        return out.cpu().numpy()
    out = engine.query(np.asarray(points), sign_convention=sign_convention)
    ENGINE_COUNTS["native"] += 1
    return out
