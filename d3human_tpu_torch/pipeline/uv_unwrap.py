"""UV parametrization, host numpy / scipy (the port's own copy of
``d3human_tpu/pipeline/uv_unwrap.py``; equal to it bit for bit on the
same inputs): charts, per-chart LSCM, packing, as xatlas does.

  1. **Charts**: greedy region growing over the face adjacency graph; a
     chart takes a neighbouring face while its normal stays within
     ``max_angle`` of the chart's running mean normal and the chart has
     fewer than ``max_chart_faces`` faces.
  2. **Per chart**: LSCM (Levy et al. 2002), the conformal energy with
     the two farthest-apart boundary vertices pinned, as a sparse real
     least-squares system solved by ``scipy.sparse.linalg.lsqr``. A chart
     the solver fails on is projected onto its mean-normal plane (any
     exception, as in the JAX package).
  3. **Packing**: each chart scaled to UV area = 3D area, then shelf-packed
     into [0, 1]^2 by decreasing height with a margin.

Outputs follow xatlas: per-corner UVs with their own index buffer
(``uvs [Nuv, 2]``, ``t_tex_idx [F, 3]``); seam vertices are duplicated
in UV space only. It runs once per bake, on the host.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# mesh adjacency
# ---------------------------------------------------------------------------

def face_normals_np(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    n = np.cross(e1, e2)
    l = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(l, 1e-20)


def face_areas_np(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)


def face_adjacency(faces: np.ndarray) -> List[List[int]]:
    """Faces sharing an (undirected) edge are adjacent."""
    edge_owner = {}
    adj: List[List[int]] = [[] for _ in range(len(faces))]
    for fi, (a, b, c) in enumerate(faces):
        for u, v in ((a, b), (b, c), (c, a)):
            e = (u, v) if u < v else (v, u)
            o = edge_owner.get(e)
            if o is None:
                edge_owner[e] = fi
            else:
                adj[o].append(fi)
                adj[fi].append(o)
    return adj


# ---------------------------------------------------------------------------
# 1. chart segmentation
# ---------------------------------------------------------------------------

def grow_charts(verts: np.ndarray, faces: np.ndarray,
                max_angle_deg: float = 65.0,
                max_chart_faces: int = 4000) -> np.ndarray:
    """Greedy normal-similarity region growing. Returns chart id per face."""
    F = len(faces)
    normals = face_normals_np(verts, faces)
    adj = face_adjacency(faces)
    cos_thresh = float(np.cos(np.deg2rad(max_angle_deg)))
    chart = np.full(F, -1, np.int64)
    cid = 0
    order = np.argsort(-face_areas_np(verts, faces))  # seed large faces first
    for seed in order:
        if chart[seed] >= 0:
            continue
        mean_n = normals[seed].copy()
        stack = [int(seed)]
        chart[seed] = cid
        count = 1
        while stack and count < max_chart_faces:
            f = stack.pop()
            for g in adj[f]:
                if chart[g] >= 0:
                    continue
                if normals[g] @ mean_n < cos_thresh:
                    continue
                chart[g] = cid
                count += 1
                # running mean keeps charts from curling past the threshold
                mean_n = mean_n + (normals[g] - mean_n) / count
                mean_n /= max(np.linalg.norm(mean_n), 1e-20)
                stack.append(int(g))
                if count >= max_chart_faces:
                    break
        cid += 1
    return chart


# ---------------------------------------------------------------------------
# 2. per-chart parametrization
# ---------------------------------------------------------------------------

def _local_frames(verts, faces):
    """Per-triangle orthonormal 2D frames: returns local coords [F,3,2]."""
    p0, p1, p2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    e1 = p1 - p0
    x = e1 / np.maximum(np.linalg.norm(e1, axis=1, keepdims=True), 1e-20)
    n = np.cross(e1, p2 - p0)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    y = np.cross(n, x)
    loc = np.zeros((len(faces), 3, 2))
    loc[:, 1, 0] = np.einsum("ij,ij->i", p1 - p0, x)
    loc[:, 2, 0] = np.einsum("ij,ij->i", p2 - p0, x)
    loc[:, 2, 1] = np.einsum("ij,ij->i", p2 - p0, y)
    return loc


def _boundary_vertices(faces_l: np.ndarray) -> np.ndarray:
    """Vertices on edges used by exactly one face (chart-local indices)."""
    cnt = {}
    for a, b, c in faces_l:
        for u, v in ((a, b), (b, c), (c, a)):
            e = (u, v) if u < v else (v, u)
            cnt[e] = cnt.get(e, 0) + 1
    bnd = set()
    for (u, v), k in cnt.items():
        if k == 1:
            bnd.add(u)
            bnd.add(v)
    return np.asarray(sorted(bnd), np.int64)


def lscm_chart(verts_c: np.ndarray, faces_l: np.ndarray) -> np.ndarray:
    """LSCM UVs for one chart (chart-local verts/faces). Returns [Vc, 2].

    Minimizes the conformal energy || W @ u ||^2 (complex) with two pinned
    vertices; assembled as a real sparse least-squares problem."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    Vc = len(verts_c)
    Fc = len(faces_l)
    if Fc == 1:
        loc = _local_frames(verts_c, faces_l)[0]
        uv = np.zeros((Vc, 2))
        uv[faces_l[0]] = loc
        return uv

    loc = _local_frames(verts_c, faces_l)               # [Fc, 3, 2]
    # complex vertex weights per triangle (Levy02 eq. between projected
    # coords): W_j = (x_{j+2} - x_{j+1}) + i (y_{j+2} - y_{j+1}), scaled
    # by 1/sqrt(2A) so every triangle contributes equally per unit area.
    x, y = loc[..., 0], loc[..., 1]
    area = 0.5 * np.abs(
        (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
        - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0]))
    s = 1.0 / np.sqrt(np.maximum(2.0 * area, 1e-20))
    Wre = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2],
                    x[:, 1] - x[:, 0]], 1) * s[:, None]
    Wim = np.stack([y[:, 2] - y[:, 1], y[:, 0] - y[:, 2],
                    y[:, 1] - y[:, 0]], 1) * s[:, None]

    # pin the two farthest-apart boundary vertices (xatlas pins extremal
    # boundary points the same way); fall back to any two vertices
    bnd = _boundary_vertices(faces_l)
    cand = bnd if len(bnd) >= 2 else np.arange(Vc)
    d = np.linalg.norm(verts_c[cand][:, None] - verts_c[cand][None], axis=-1)
    i0, i1 = np.unravel_index(np.argmax(d), d.shape)
    pin = np.asarray([cand[i0], cand[i1]])
    pin_uv = np.asarray([[0.0, 0.0],
                         [np.linalg.norm(verts_c[pin[1]] - verts_c[pin[0]]),
                          0.0]])

    free = np.setdiff1d(np.arange(Vc), pin)
    col_of = np.full(Vc, -1)
    col_of[free] = np.arange(len(free))
    nf = len(free)

    # real 2T x 2nf system: rows (Re, Im) of sum_j (Wre+iWim)(u+iv),
    # assembled fully vectorized over the (t, j) corner grid
    tt = np.repeat(np.arange(Fc), 3)                    # [3Fc]
    vv = faces_l.reshape(-1)
    wr = Wre.reshape(-1)
    wi = Wim.reshape(-1)
    is_free = col_of[vv] >= 0

    fr_t, fr_c = tt[is_free], col_of[vv[is_free]]
    fr_wr, fr_wi = wr[is_free], wi[is_free]
    rows = np.concatenate([fr_t, fr_t, Fc + fr_t, Fc + fr_t])
    cols = np.concatenate([fr_c, nf + fr_c, fr_c, nf + fr_c])
    vals = np.concatenate([fr_wr, -fr_wi, fr_wi, fr_wr])

    brhs = np.zeros(2 * Fc)
    pn = ~is_free
    puv = np.where(vv[pn, None] == pin[0], pin_uv[0], pin_uv[1])  # [np, 2]
    np.add.at(brhs, tt[pn], -(wr[pn] * puv[:, 0] - wi[pn] * puv[:, 1]))
    np.add.at(brhs, Fc + tt[pn], -(wi[pn] * puv[:, 0] + wr[pn] * puv[:, 1]))
    if nf:
        A = sp.csr_matrix((vals, (rows, cols)), shape=(2 * Fc, 2 * nf))
        sol = spla.lsqr(A, brhs, atol=1e-10, btol=1e-10, iter_lim=4000)[0]
    uv = np.zeros((Vc, 2))
    uv[pin[0]] = pin_uv[0]
    uv[pin[1]] = pin_uv[1]
    if nf:
        uv[free, 0] = sol[:nf]
        uv[free, 1] = sol[nf:]
    if not np.isfinite(uv).all():
        raise FloatingPointError("LSCM produced non-finite UVs")
    return uv


def _project_chart(verts_c: np.ndarray, faces_l: np.ndarray) -> np.ndarray:
    """Fallback parametrization: project onto the chart's mean-normal plane
    (charts are grown nearly planar, so distortion stays bounded)."""
    n = face_normals_np(verts_c, faces_l)
    a = face_areas_np(verts_c, faces_l)
    mean_n = (n * a[:, None]).sum(0)
    mean_n /= max(np.linalg.norm(mean_n), 1e-20)
    ref = np.array([1.0, 0.0, 0.0])
    if abs(mean_n @ ref) > 0.9:
        ref = np.array([0.0, 1.0, 0.0])
    x = np.cross(mean_n, ref)
    x /= max(np.linalg.norm(x), 1e-20)
    y = np.cross(mean_n, x)
    return np.stack([verts_c @ x, verts_c @ y], 1)


# ---------------------------------------------------------------------------
# 3. packing
# ---------------------------------------------------------------------------

def shelf_pack(sizes: np.ndarray, margin: float = 0.005
               ) -> Tuple[np.ndarray, float]:
    """Shelf packing of (w, h) boxes. Returns offsets [N,2] and the side
    of the square canvas used (caller rescales everything by 1/side)."""
    order = np.argsort(-sizes[:, 1])                    # tall shelves first
    total_area = float(((sizes[:, 0] + margin)
                        * (sizes[:, 1] + margin)).sum())
    width = max(np.sqrt(total_area), sizes[:, 0].max() + margin) * 1.05
    off = np.zeros((len(sizes), 2))
    cx = margin
    cy = margin
    shelf_h = 0.0
    for i in order:
        w, h = sizes[i]
        if cx + w + margin > width:
            cy += shelf_h + margin
            cx = margin
            shelf_h = 0.0
        off[i] = (cx, cy)
        cx += w + margin
        shelf_h = max(shelf_h, h)
    side = max(width, cy + shelf_h + margin)
    return off, float(side)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def unwrap(verts: np.ndarray, faces: np.ndarray,
           max_angle_deg: float = 65.0, max_chart_faces: int = 4000,
           margin: float = 0.005):
    """Full xatlas-style parametrize. Returns (uvs [Nuv,2] in [0,1],
    t_tex_idx [F,3] int64, chart_of_face [F] int64)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    chart = grow_charts(verts, faces, max_angle_deg, max_chart_faces)
    n_charts = int(chart.max()) + 1

    uv_all: List[np.ndarray] = []
    idx_all = np.zeros((len(faces), 3), np.int64)
    sizes = np.zeros((n_charts, 2))
    mins = np.zeros((n_charts, 2))
    chart_slices = []
    base = 0
    for c in range(n_charts):
        fsel = np.nonzero(chart == c)[0]
        fc = faces[fsel]
        vids = np.unique(fc)
        local = np.searchsorted(vids, fc)
        vc = verts[vids]
        try:
            uv = lscm_chart(vc, local)
        except Exception:
            uv = _project_chart(vc, local)
        # normalize texel density: UV area == 3D area (then packing
        # rescales globally), so every chart gets uniform resolution
        a3 = face_areas_np(vc, local).sum()
        x, y = uv[local[:, 0]], uv[local[:, 1]]
        z = uv[local[:, 2]]
        e1, e2 = y - x, z - x
        a2 = float(np.abs(0.5 * (e1[:, 0] * e2[:, 1]
                                 - e1[:, 1] * e2[:, 0])).sum())
        uv = uv * np.sqrt(a3 / max(a2, 1e-20))
        mn = uv.min(0)
        uv = uv - mn
        mins[c] = 0.0
        sizes[c] = uv.max(0)
        uv_all.append(uv)
        idx_all[fsel] = local + base
        chart_slices.append((base, base + len(vids)))
        base += len(vids)

    off, side = shelf_pack(sizes, margin)
    uvs = np.concatenate(uv_all, 0)
    for c, (s0, s1) in enumerate(chart_slices):
        uvs[s0:s1] += off[c]
    uvs /= side
    return uvs.astype(np.float32), idx_all, chart
