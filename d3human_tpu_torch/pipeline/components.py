"""Connected-component clean-up of the split meshes on the host (numpy
copy of ``d3human_tpu/pipeline/components.py``; ref
script/connet_face_head.py:152-261, process_close_hole).

After the split stage the body and cloth meshes can hold stray islands.
Components are labelled by a union-find over the faces; each island of at
least ``min_keep_faces`` faces moves to the mesh whose main component it
lies closer to on average, smaller ones are dropped. The head box is the
top fraction of the body's height span.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from d3human_tpu_torch.ops.mesh_ops import connected_components
from d3human_tpu_torch.utils import io as mesh_io

SCRATCH_ELEMS = 1 << 24   # point pairs of one block of _nearest_dist


def split_components(verts: np.ndarray, faces: np.ndarray
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(vertex ids, face ids) of each connected component, most faces
    first (equal sizes in the order of their root labels)."""
    labels = connected_components(faces, len(verts))
    face_label = labels[faces[:, 0]]
    comps = []
    for lbl in np.unique(face_label):
        fidx = np.nonzero(face_label == lbl)[0]
        comps.append((np.unique(faces[fidx]), fidx))
    comps.sort(key=lambda c: -len(c[1]))
    return comps


def _nearest_dist(src: np.ndarray, dst: np.ndarray, block: int = 4096
                  ) -> np.ndarray:
    """Distance from each src point to its nearest dst point, by brute
    force over blocks of src rows (at most ``SCRATCH_ELEMS`` pairs a
    block; each row's value does not depend on the blocking)."""
    block = max(1, min(block, SCRATCH_ELEMS // max(len(dst), 1)))
    out = np.empty(len(src), np.float32)
    for i in range(0, len(src), block):
        s = src[i:i + block]
        out[i:i + block] = np.sqrt(
            ((s[:, None, :] - dst[None, :, :]) ** 2).sum(-1)).min(axis=1)
    return out


def reassign_components(
    body_v: np.ndarray, body_f: np.ndarray,
    cloth_v: np.ndarray, cloth_f: np.ndarray, min_keep_faces: int = 50,
    report: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(body verts, body faces, cloth verts, cloth faces) after moving each
    island to the mesh whose main component is nearer on average and
    dropping islands under ``min_keep_faces`` faces. Each output mesh holds
    only the vertices its faces use. ``report``, when given, receives the
    component counts: per mesh, its components, the islands it kept, gave
    to the other mesh and dropped."""
    meshes = {"body": (body_v, body_f), "cloth": (cloth_v, cloth_f)}
    comps = {k: split_components(*m) for k, m in meshes.items()}
    main = {k: meshes[k][0][c[0][0]] if c else np.zeros((1, 3))
            for k, c in comps.items()}
    keep = {"body": [], "cloth": []}   # (source mesh, face ids)
    for own, other in (("body", "cloth"), ("cloth", "body")):
        verts = meshes[own][0]
        n = {"components": len(comps[own]), "kept": 0, "moved": 0,
             "dropped": 0}
        for i, (vidx, fidx) in enumerate(comps[own]):
            if i == 0:
                keep[own].append((own, fidx))
                continue
            if len(fidx) < min_keep_faces:
                n["dropped"] += 1
                continue
            pts = verts[vidx]
            d_own = _nearest_dist(pts, main[own]).mean()
            d_other = _nearest_dist(pts, main[other]).mean()
            stays = d_own <= d_other
            n["kept" if stays else "moved"] += 1
            keep[own if stays else other].append((own, fidx))
        if report is not None:
            report[own] = n

    def concat(parts):
        vs, fs, off = [], [], 0
        for src, fidx in parts:
            verts, faces = meshes[src]
            used, inv = np.unique(faces[fidx].reshape(-1),
                                  return_inverse=True)
            vs.append(verts[used])
            fs.append(inv.reshape(-1, 3) + off)
            off += len(used)
        if not vs:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
        return np.concatenate(vs), np.concatenate(fs)

    return (*concat(keep["body"]), *concat(keep["cloth"]))


def head_bbox(body_v: np.ndarray, top_fraction: float = 0.18) -> np.ndarray:
    """[2, 3] box (lo, hi) of the body vertices in the top ``top_fraction``
    of its height span; all zeros for an empty body (a split that never
    separated a body half), so that no face falls in it."""
    if len(body_v) == 0:
        print("[components] WARNING: empty body mesh, head bbox is empty "
              "(under-trained split?)", flush=True)
        return np.zeros((2, 3), np.float32)
    y0, y1 = body_v[:, 1].min(), body_v[:, 1].max()
    head = body_v[body_v[:, 1] >= y1 - (y1 - y0) * top_fraction]
    if len(head) == 0:
        head = body_v
    return np.stack([head.min(axis=0), head.max(axis=0)])


def process_close_hole(out_dir: str, body_obj: str, cloth_obj: str
                       ) -> Dict:
    """Load the split meshes, reassign their components, write
    ``body_concat.obj``, ``cloth_concat.obj`` and the head box
    ``bbox.npz`` into ``out_dir``; returns their paths under ``body``,
    ``cloth`` and ``bbox``, and the component counts under
    ``components``."""
    os.makedirs(out_dir, exist_ok=True)
    report: dict = {}
    nbv, nbf, ncv, ncf = reassign_components(*mesh_io.load_obj(body_obj),
                                             *mesh_io.load_obj(cloth_obj),
                                             report=report)
    out = {"body": os.path.join(out_dir, "body_concat.obj"),
           "cloth": os.path.join(out_dir, "cloth_concat.obj"),
           "bbox": os.path.join(out_dir, "bbox.npz"), "components": report}
    mesh_io.write_obj(out["body"], nbv, nbf)
    mesh_io.write_obj(out["cloth"], ncv, ncf)
    np.savez(out["bbox"], bbox=head_bbox(nbv))
    return out
