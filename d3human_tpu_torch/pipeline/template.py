"""Watertight animatable template construction between the split and the
seq stage (counterpart of ``d3human_tpu/pipeline/template.py``; ref
script/process_body_cloth_head_msdfcut.py:613-951).

``merge_body_cloth`` builds ``merge_body_cloth.npz`` (``v``, ``f``,
``face_labels``: the merged template, body faces 0 and cloth faces 1) and
``inside_body_index.npz`` (the body vertices inside / outside the
watertight cloth):

  * the split body's ragged rim is trimmed; where a SMPL template is
    given, its piece under the cloth is cut out, trimmed and pushed inside
    the cloth, and joins the body soup;
  * the soup is made watertight by ``rewatertight``: its signed distance
    on a lattice (the native engine, ``ops/mesh_sdf.py:mesh_sdf_host``),
    then a G-Shell extraction with mSDF = 1 on the device;
  * the result is cluster-decimated, midpoint-subdivided in the head box,
    pushed under the cloth and merged with it.

The tensor steps (``rewatertight``'s extraction, ``push_body_inside_cloth``
and ``distance_cut``) run on ``device``; the rest is host numpy.
``build_seq_template`` turns the merge into a ``SeqTemplate``.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from d3human_tpu_torch.models.geometry import SeqTemplate
from d3human_tpu_torch.ops import mesh_ops
from d3human_tpu_torch.ops.knn import knn1
from d3human_tpu_torch.ops.marching_tets import gshell_extract
from d3human_tpu_torch.ops.mesh_ops import (
    connected_components, find_connected_faces,
)
from d3human_tpu_torch.ops.mesh_sdf import face_centroids, mesh_sdf_host
from d3human_tpu_torch.ops.tet_grid import make_tet_grid
from d3human_tpu_torch.utils import io as mesh_io


def _dev(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)


def rewatertight(verts: np.ndarray, faces: np.ndarray, grid_res: int = 96,
                 margin: float = 0.06, max_verts: int = 2 ** 17,
                 max_tets: int = 2 ** 17, device="cuda",
                 report: Optional[dict] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """A closed remesh of a (possibly holey) surface: its signed distance
    on a ``grid_res`` lattice over its box grown by ``margin`` (the host
    engine, once), the watertight level of a G-Shell extraction on
    ``device`` (capacities doubled up to 4 tries while they overflow),
    compacted and welded. ``report``, when given, receives the tries, the
    last try's crossing edges and sign-mixed tets and its capacities (an
    overflow left after 4 tries drops faces, as in the JAX package)."""
    lo = verts.min(axis=0) - margin
    hi = verts.max(axis=0) + margin
    grid = make_tet_grid(res=grid_res, bounds=(tuple(lo), tuple(hi)),
                         y_offset=0.0, scale=1.0, device=device)
    sdf = _dev(mesh_sdf_host(mesh_io.host(grid.verts), verts, faces,
                             sign_convention="pos_inside", device=device),
               torch.float32, device)
    mv, mt = max_verts, max_tets
    with torch.no_grad():
        for tries in range(1, 5):
            mesh = gshell_extract(grid, grid.verts, sdf, torch.ones_like(sdf),
                                  mv, mt)
            n_cross, n_tets = int(mesh.n_cross), int(mesh.n_valid_tets)
            if n_cross <= mv and n_tets <= mt:
                break
            if tries < 4:
                mv, mt = mv * 2, mt * 2
    if report is not None:
        report.update(tries=tries, n_cross=n_cross, n_valid_tets=n_tets,
                      max_verts=mv, max_tets=mt)
    wv, wf = mesh_io.compact_mesh(mesh.verts_wt, mesh.faces_wt,
                                  mesh.face_wt_valid)
    return mesh_io.weld_mesh(wv, wf)


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


def push_body_inside_cloth(body_v: np.ndarray, body_f: np.ndarray,
                           cloth_v: np.ndarray, cloth_f: np.ndarray,
                           push_eps: float = 0.004, influence: float = 0.03,
                           device="cuda") -> np.ndarray:
    """The body vertices, those within ``influence`` of the nearest cloth
    face centre and not ``push_eps`` behind its plane moved inward along
    their vertex normal to ``push_eps`` behind it (ref
    deform_body_collision, script...:331). On ``device``: the vertex
    normals' sum is the scatter kernel, the search ``knn1``."""
    bv = _dev(body_v, torch.float32, device)
    cv = _dev(cloth_v, torch.float32, device)
    bf = _dev(body_f, torch.int64, device)
    cf = _dev(cloth_f, torch.int64, device)
    with torch.no_grad():
        n_body = mesh_ops.auto_normals(bv, bf)
        centers = face_centroids(cv, cf)
        n_cloth = mesh_ops.face_normals(cv, cf)
        sq, idx = knn1(bv, centers)
        d = torch.sqrt(sq + 1e-12)
        # positive: the body vertex lies outside the cloth surface
        signed = ((bv - centers[idx]) * n_cloth[idx]).sum(-1)
        need = (d < influence) & (signed > -push_eps)
        shift = torch.where(need, signed + push_eps, 0.0)
        return mesh_io.host(bv - n_body * shift[:, None])


def find_open_edges(faces: np.ndarray) -> np.ndarray:
    """The vertices on boundary edges (edges of one face; ref
    find_open_edges, script...:92-102)."""
    edges = np.sort(np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0),
        axis=1)
    uniq, counts = np.unique(edges, axis=0, return_counts=True)
    return np.unique(uniq[counts == 1])


def trim_open_edges(faces: np.ndarray, iters: int = 2) -> np.ndarray:
    """Drop the faces that touch a boundary vertex, ``iters`` times: peels
    the ragged rim of a split mesh (ref script...:692-696, :672-676)."""
    f = np.asarray(faces)
    for _ in range(iters):
        open_v = find_open_edges(f)
        if len(open_v) == 0:
            break
        f = f[~np.isin(f, open_v).any(axis=1)]
    return f


def _face_components(n_verts: int, faces: np.ndarray) -> np.ndarray:
    """Per-face component ids of faces joined by shared vertices (ids in
    the order of the components' root vertices)."""
    roots = connected_components(faces, n_verts)[np.asarray(faces)[:, 0]]
    return np.unique(roots, return_inverse=True)[1].reshape(-1)


def distance_cut(src_v: np.ndarray, src_f: np.ndarray, ref_v: np.ndarray,
                 thresh: float = 0.02, device="cuda") -> np.ndarray:
    """The faces of ``src`` whose corners all lie within ``thresh`` of the
    nearest ``ref`` point (``knn1`` on ``device``), largest connected piece
    only (ref script...:434-456, :631-650): the SMPL template's piece under
    the cloth."""
    with torch.no_grad():
        sq, _ = knn1(_dev(src_v, torch.float32, device),
                     _dev(ref_v, torch.float32, device))
        d = mesh_io.host(torch.sqrt(sq + 1e-12))
    valid = src_f[(d <= thresh)[src_f].all(axis=1)]
    if len(valid) == 0:
        return valid
    comp = _face_components(len(src_v), valid)
    return valid[comp == np.bincount(comp).argmax()]


def merge_body_cloth(out_dir: str, body_obj: str, cloth_obj: str,
                     grid_res: int = 96, cover_eps: float = 0.02,
                     smpl_obj: str | None = None, bbox_npz: str | None = None,
                     smpl_cut_thresh: float = 0.02, trim_iters: int = 2,
                     device="cuda") -> Dict:
    """Write ``merge_body_cloth.npz`` {v, f, face_labels} (and its .obj)
    and ``inside_body_index.npz`` {inside_body_index, outside_body_index}
    into ``out_dir`` (ref process_body_msdf_distance_bodyedge,
    script...:613-748). Returns their paths under ``mesh`` / ``indices``
    and the counts of each step under ``counts``, with ``branch``: which
    way the body vertices were classified (``watertight_cloth``: the sign
    of the watertight cloth's SDF; ``distance_cover``: within
    ``cover_eps`` of a cloth face centre, when the cloth's re-extraction
    raised, the error under ``error``)."""
    os.makedirs(out_dir, exist_ok=True)
    bv, bf = mesh_io.load_obj(body_obj)
    cv, cf = mesh_io.load_obj(cloth_obj)
    counts = {"body_faces_in": len(bf), "cloth_faces": len(cf)}

    # 1. the split body's ragged rim
    bf = trim_open_edges(bf, iters=trim_iters)
    counts["body_faces_trimmed"] = len(bf)

    # 2. the SMPL piece under the cloth
    soup_v, soup_f = bv, bf
    counts["smpl_patch_faces"] = 0
    if smpl_obj is not None:
        sv, sf = mesh_io.load_obj(smpl_obj)
        sf_cut = distance_cut(sv, sf, cv, thresh=smpl_cut_thresh,
                              device=device)
        if len(sf_cut):
            sf_cut = trim_open_edges(sf_cut, iters=1)
        counts["smpl_patch_faces"] = len(sf_cut)
        if len(sf_cut):
            sv = push_body_inside_cloth(sv, sf_cut, cv, cf, device=device)
            soup_v = np.concatenate([soup_v, sv]).astype(np.float32)
            soup_f = np.concatenate([soup_f, sf_cut + len(bv)])

    # 3. the watertight body, decimated to the seq stage's density before
    # the head subdivision
    counts["body_extraction"] = {}
    wbv, wbf = rewatertight(soup_v, soup_f, grid_res=grid_res, device=device,
                            report=counts["body_extraction"])
    counts["watertight_faces"] = len(wbf)
    wbv, wbf = cluster_decimate(wbv, wbf, n_cells=512, target_faces=300_000)
    counts["decimated_faces"] = len(wbf)

    # 4. the head subdivision
    if bbox_npz is not None and os.path.exists(bbox_npz):
        bbox = np.load(bbox_npz)["bbox"]
        counts["head_bbox"] = bbox.tolist()
        wbv, wbf = midpoint_subdivide_in_bbox(wbv, wbf, bbox)
    counts["body_faces"] = len(wbf)

    # 5. the body under the cloth, the merge
    wbv = push_body_inside_cloth(wbv, wbf, cv, cf, device=device)
    v = np.concatenate([wbv, cv]).astype(np.float32)
    f = np.concatenate([wbf, cf + len(wbv)]).astype(np.int64)
    face_labels = np.concatenate([np.zeros(len(wbf), np.int64),
                                  np.ones(len(cf), np.int64)])
    # the rasterizer packs face ids into 20 bits
    assert len(f) < (1 << 20), (
        f"merged template has {len(f)} faces; lower cluster_decimate's "
        f"target_faces or the merge grid_res")
    counts.update(merged_faces=len(f), merged_verts=len(v),
                  body_verts=len(wbv))

    # body vertices inside the watertight cloth; by distance to the cloth
    # when the cloth cannot be re-extracted
    out = {}
    try:
        counts["cloth_extraction"] = {}
        wcv, wcf = rewatertight(cv, cf, grid_res=min(64, grid_res),
                                device=device,
                                report=counts["cloth_extraction"])
        sd = mesh_sdf_host(wbv, wcv, wcf, sign_convention="pos_inside",
                           device=device)
        inside, outside = np.nonzero(sd > 0)[0], np.nonzero(sd <= 0)[0]
        out["branch"] = "watertight_cloth"
    except Exception as e:  # noqa: BLE001  (the JAX package's fallback)
        print(f"merge_body_cloth: the cloth's re-extraction failed ({e!r});"
              f" classifying the body vertices by distance", file=sys.stderr,
              flush=True)
        with torch.no_grad():
            sq, _ = knn1(_dev(wbv, torch.float32, device),
                         face_centroids(_dev(cv, torch.float32, device),
                                        _dev(cf, torch.int64, device)))
            d = mesh_io.host(torch.sqrt(sq + 1e-12))
        inside, outside = np.nonzero(d < cover_eps)[0], \
            np.nonzero(d >= cover_eps)[0]
        out.update(branch="distance_cover", error=repr(e))
    counts.update(inside_body_verts=len(inside),
                  outside_body_verts=len(outside))

    mesh_path = os.path.join(out_dir, "merge_body_cloth.npz")
    np.savez(mesh_path, v=v, f=f, face_labels=face_labels)
    mesh_io.write_obj(os.path.join(out_dir, "merge_body_cloth.obj"), v, f)
    idx_path = os.path.join(out_dir, "inside_body_index.npz")
    np.savez(idx_path, inside_body_index=inside, outside_body_index=outside)
    return dict(out, mesh=mesh_path, indices=idx_path, counts=counts)


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


def build_seq_template(process_dir: str, device="cuda") -> SeqTemplate:
    """``process_dir/merge_body_cloth.npz`` -> ``SeqTemplate``, each vertex
    labelled by the majority of its faces (ties: body; ref
    train.py:1865-1918)."""
    z = np.load(os.path.join(process_dir, "merge_body_cloth.npz"))
    v = z["v"].astype(np.float32)
    f = z["f"].astype(np.int64)
    face_labels = z["face_labels"].astype(np.int64)
    counts = np.zeros((len(v), 2), np.int64)
    for lbl in (0, 1):
        np.add.at(counts[:, lbl], f[face_labels == lbl].reshape(-1), 1)
    return seq_template(v, f, face_labels, counts.argmax(axis=1), device)
