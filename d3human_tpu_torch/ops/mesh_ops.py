"""Masked mesh operations on fixed-capacity buffers (counterpart of
``d3human_tpu/ops/mesh_ops.py``): the normals, the surface sampler, the
seq stage's smoothness losses, the normal consistency of a mesh whose
topology changes (``edge_normal_consistency_loss``) and the host-side
face adjacency and connected components of a static mesh."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from d3human_tpu_torch.ops.scan import inclusive_scan
from d3human_tpu_torch.ops.scatter import gather_rows, segment_add_rows


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=True),
                                          eps))


def face_normals(verts: torch.Tensor, faces: torch.Tensor,
                 normalize: bool = True) -> torch.Tensor:
    """One fused corner gather (scatter kernel in the backward)."""
    tri = gather_rows(verts, faces)                       # [F, 3, 3]
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    n = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    return safe_normalize(n) if normalize else n


def auto_normals(verts: torch.Tensor, faces: torch.Tensor,
                 face_valid: Optional[torch.Tensor] = None,
                 fn_raw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Area-weighted vertex normals: the unnormalized face normals of all
    three corners summed per vertex by ONE scatter (the scatter kernel in
    the forward). Degenerate normals fall back to +z. ``fn_raw`` passes
    precomputed unnormalized face normals."""
    fn = face_normals(verts, faces, normalize=False) if fn_raw is None \
        else fn_raw
    if face_valid is not None:
        fn = torch.where(face_valid[:, None], fn,
                         torch.zeros((), device=fn.device))
    v_nrm = segment_add_rows(fn.repeat(3, 1), faces.T.reshape(-1),
                             verts.shape[0])
    bad = (v_nrm * v_nrm).sum(-1, keepdim=True) <= 1e-20
    v_nrm = torch.where(bad, torch.tensor([0.0, 0.0, 1.0],
                                          device=fn.device), v_nrm)
    return safe_normalize(v_nrm)


def laplacian_uniform_loss(verts: torch.Tensor, faces: torch.Tensor
                           ) -> torch.Tensor:
    """mean ||L V||^2 of the uniform (umbrella) Laplacian, matrix-free:
    each vertex's [neighbour sum | degree] over both directions of the
    three face edges in ONE scatter of 6F rows x 4 floats, in the JAX
    package's row order; the corners come from one fused row gather (its
    backward is the scatter kernel too)."""
    V = verts.shape[0]
    w = torch.ones((faces.shape[0], 1), dtype=verts.dtype,
                   device=verts.device)
    tri = gather_rows(verts, faces)                       # [F, 3, 3]
    idx_parts, val_parts = [], []
    for a, b in ((0, 1), (1, 2), (2, 0)):
        idx_parts += [faces[:, a], faces[:, b]]
        val_parts += [torch.cat([tri[:, b], w], dim=-1),
                      torch.cat([tri[:, a], w], dim=-1)]
    acc = segment_add_rows(torch.cat(val_parts), torch.cat(idx_parts), V)
    nbr_sum, deg = acc[:, :3], acc[:, 3]
    lap = nbr_sum / torch.clamp_min(deg, 1.0)[:, None] - verts
    ok = deg > 0
    sq = (lap * lap).sum(-1)
    return (torch.where(ok, sq, torch.zeros((), device=sq.device)).sum()
            / torch.clamp_min(ok.sum(), 1))


def normal_consistency_loss(verts: torch.Tensor, faces: torch.Tensor,
                            connected_faces: torch.Tensor) -> torch.Tensor:
    """mean (1 - cos(n_i, n_j))^2 over the adjacent face pairs
    ``connected_faces`` [P, 2]; both gathers' backwards are the scatter
    kernel."""
    n = gather_rows(face_normals(verts, faces), connected_faces)  # [P, 2, 3]
    cos = torch.clamp((n[:, 0] * n[:, 1]).sum(-1), -1.0, 1.0)
    return ((1.0 - cos) ** 2).mean()


def edge_normal_consistency_loss(verts: torch.Tensor, faces: torch.Tensor,
                                 face_valid: torch.Tensor) -> torch.Tensor:
    """Normal consistency for meshes whose adjacency cannot be precomputed:
    each live face normal's mean deviation (1 - cos) / 2 from the mean
    normal of its three vertices, averaged over the live faces. The
    per-vertex [normal sum | count] is ONE scatter of 3F rows x 4 (the
    scatter kernel), the corners' mean normals one fused row gather."""
    fn = face_normals(verts, faces)
    w = face_valid.to(verts.dtype)
    fw = torch.cat([fn * w[:, None], w[:, None]], dim=-1)
    acc = segment_add_rows(fw.repeat(3, 1), faces.T.reshape(-1),
                           verts.shape[0])
    mean_n = safe_normalize(acc[:, :3] / torch.clamp_min(acc[:, 3], 1.0)
                            [:, None])
    corner_n = gather_rows(mean_n, faces)                 # [F, 3, 3]
    dev = 0.0
    for k in range(3):
        cos = torch.clamp((fn * corner_n[:, k]).sum(-1), -1, 1)
        dev = dev + (1.0 - cos) * 0.5
    dev = dev / 3.0
    return (dev * w).sum() / torch.clamp_min(w.sum(), 1.0)


def find_connected_faces(faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side adjacency of a static mesh: (connected_faces [P, 2] int64,
    edges [E, 2]) over the edges shared by exactly two faces."""
    f = np.asarray(faces)
    e = np.sort(f[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), axis=1)
    face_ids = np.repeat(np.arange(len(f)), 3)
    key = e[:, 0].astype(np.int64) << 32 | e[:, 1].astype(np.int64)
    order = np.argsort(key, kind="stable")
    ks, fs = key[order], face_ids[order]
    uniq, start, counts = np.unique(ks, return_index=True, return_counts=True)
    two = counts == 2
    pairs = np.stack([fs[start[two]], fs[start[two] + 1]], axis=1)
    edges = np.stack([uniq >> 32, uniq & 0xFFFFFFFF], axis=1).astype(np.int64)
    return pairs.astype(np.int64), edges


def sample_points_on_mesh(
    verts: torch.Tensor, faces: torch.Tensor, n_samples: int,
    face_valid: Optional[torch.Tensor] = None,
    fn_raw: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Area-weighted surface samples [n, 3]: inverse-CDF over face areas,
    then uniform barycentrics. ``draws = (u [n], uv [n, 2])`` injects the
    uniform numbers (tests pass the JAX package's); otherwise they come
    from ``generator``. ``fn_raw`` = precomputed unnormalized normals.
    The area CDF is ``inclusive_scan`` and the corners a ``gather_rows``:
    both add in a fixed order on the card."""
    fn = face_normals(verts, faces, normalize=False) if fn_raw is None \
        else fn_raw
    area = 0.5 * torch.sqrt(torch.clamp_min((fn * fn).sum(-1), 1e-20))
    if face_valid is not None:
        area = torch.where(face_valid, area, torch.zeros((), device=area.device))
    if draws is None:
        u01 = torch.rand((n_samples,), generator=generator,
                         device=verts.device)
        uv = torch.rand((n_samples, 2), generator=generator,
                        device=verts.device)
    else:
        u01, uv = (d.to(verts.device) for d in draws)
    cdf = inclusive_scan(area)
    u = u01 * cdf[-1]
    fidx = torch.searchsorted(cdf, u).clamp(0, area.shape[0] - 1)
    su = torch.sqrt(uv[:, 0:1])
    b0 = 1.0 - su
    b1 = su * (1.0 - uv[:, 1:2])
    b2 = su * uv[:, 1:2]
    tri = gather_rows(verts, faces[fidx])                 # [S, 3, 3]
    return b0 * tri[:, 0] + b1 * tri[:, 1] + b2 * tri[:, 2]


def connected_components(faces: np.ndarray, n_verts: int) -> np.ndarray:
    """Per-vertex component labels [V] int64 of a static mesh: a
    union-find over the faces' vertices (each label is its component's
    root vertex, as the JAX package's union-find leaves it). Host-side, on
    Python lists."""
    parent = list(range(n_verts))

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for a, b, c in np.asarray(faces).tolist():
        r = find(a)
        parent[find(b)] = r
        parent[find(c)] = r
    return np.fromiter((find(i) for i in range(n_verts)), np.int64, n_verts)
