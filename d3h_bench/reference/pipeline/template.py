"""Host functions of the seq stage's template: midpoint subdivision,
vertex-cluster decimation and ``seq_template``'s index sets."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from d3h_bench.reference.models.geometry import SeqTemplate
from d3h_bench.reference.ops.mesh_ops import find_connected_faces


def cluster_decimate(v: np.ndarray, f: np.ndarray, n_cells: int = 512,
                     target_faces: int | None = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Vertex clustering: snap vertices to a uniform grid over the mesh's
    bounding box, collapse each cell to its vertices' mean, drop degenerate
    and duplicate faces. With ``target_faces`` the grid coarsens by 0.75
    until the result fits (down to 16 cells)."""
    v = np.asarray(v, np.float64)
    f = np.asarray(f)
    while True:
        lo = v.min(axis=0)
        span = float((v.max(axis=0) - lo).max()) or 1.0
        h = span / n_cells
        key = np.minimum((np.floor((v - lo) / h)).astype(np.int64),
                         n_cells - 1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        nv = np.zeros((len(uniq), 3), np.float64)
        cnt = np.zeros(len(uniq), np.int64)
        np.add.at(nv, inv, v)
        np.add.at(cnt, inv, 1)
        nv = nv / cnt[:, None]
        nf = inv[f]
        nf = nf[(nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2])
                & (nf[:, 0] != nf[:, 2])]
        _, ui = np.unique(np.sort(nf, axis=1), axis=0, return_index=True)
        nf = nf[np.sort(ui)]
        if target_faces is None or len(nf) <= target_faces or n_cells <= 16:
            return nv.astype(np.float32), nf.astype(np.int64)
        n_cells = max(16, int(n_cells * 0.75))


def midpoint_subdivide_in_bbox(v: np.ndarray, f: np.ndarray,
                               bbox, pad: float = 0.01):
    """1 -> 4 midpoint subdivision of the faces wholly inside ``bbox``
    (lo, hi) grown by ``pad``; shared edge midpoints are made once, faces
    outside are kept as they are."""
    lo, hi = np.asarray(bbox[0]) - pad, np.asarray(bbox[1]) + pad
    in_bbox = np.all((v >= lo) & (v <= hi), axis=1)
    sub = in_bbox[f].all(axis=1)
    f_in, f_out = f[sub], f[~sub]
    if len(f_in) == 0:
        return v, f
    edges = np.concatenate(
        [f_in[:, [0, 1]], f_in[:, [1, 2]], f_in[:, [2, 0]]], axis=0)
    uniq, inv = np.unique(np.sort(edges, axis=1), axis=0, return_inverse=True)
    mid = 0.5 * (v[uniq[:, 0]] + v[uniq[:, 1]])
    mid_idx = len(v) + inv.reshape(3, -1).T          # [Fin, 3]: m01, m12, m20
    v_out = np.concatenate([v, mid])
    a, b, c = f_in[:, 0], f_in[:, 1], f_in[:, 2]
    m01, m12, m20 = mid_idx[:, 0], mid_idx[:, 1], mid_idx[:, 2]
    f_new = np.concatenate([
        np.stack([a, m01, m20], 1), np.stack([m01, b, m12], 1),
        np.stack([m20, m12, c], 1), np.stack([m01, m12, m20], 1),
    ])
    return v_out.astype(np.float32), np.concatenate([f_new, f_out])


def seq_template(v: np.ndarray, f: np.ndarray, face_labels: np.ndarray,
                 v_labels: np.ndarray, device="cuda") -> SeqTemplate:
    """The ``SeqTemplate`` of a labelled mesh: the per-label vertex index
    sets, the body faces and the adjacent face pairs."""
    v_labels = np.asarray(v_labels, np.int64)
    connected, _ = find_connected_faces(f)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(
            device)

    return SeqTemplate(
        v=t(np.asarray(v, np.float32), torch.float32),
        f=t(f, torch.int32), v_labels=t(v_labels, torch.int32),
        face_labels=t(face_labels, torch.int32),
        body_vidx=t(np.nonzero(v_labels == 0)[0], torch.int32),
        cloth_vidx=t(np.nonzero(v_labels == 1)[0], torch.int32),
        body_f=t(f[face_labels == 0], torch.int32),
        connected_faces=t(connected, torch.int32))
