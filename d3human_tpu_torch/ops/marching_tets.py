"""G-Shell marching tetrahedra with static shapes.

Counterpart of ``d3human_tpu/ops/marching_tets.py`` (``_gshell_level1`` /
``_gshell_level2`` / ``gshell_extract`` / ``gshell_extract_pair`` and
``sdf_reg_loss``). Level 1 turns
SDF-crossing lattice edges into vertices (compacted to ``max_verts`` slots)
and sign-mixed tets into 1-2 triangles (compacted to ``max_tets`` slots);
level 2 re-cuts each level-1 polygon by the interpolated mSDF into the
open-shell region, with a fixed block of 4 boundary-vertex and 4 face slots
per tet. The stop-gradient placements of the JAX package (level-1 mSDF
weights and the boundary-vertex mSDF coefficients) are kept: they carry
convergence.

The two compactions run ``first_k_indices`` (CUDA kernel on the card); the
endpoint and polygon-cycle row gathers are ``gather_rows`` (scatter kernel
in the backward); the corner-mark count runs ``coo_scatter_add``.

On a lattice (``grid.dims`` set) the crossing flags, the sign-mixed flags
and ``sdf_reg_loss``'s endpoint pairs are shifted slices of the vertex
volume; on an unstructured grid (``load_reference_tet_grid``) they are
gathers over ``grid.edges`` and ``grid.tets``, the loss's through
``gather_rows``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from d3human_tpu_torch.ops.compaction import first_k_indices
from d3human_tpu_torch.ops.scatter import coo_scatter_add, gather_rows
from d3human_tpu_torch.ops.tet_grid import EDGE_CLASSES, KUHN_PATHS, TetGrid
from d3human_tpu_torch.utils.consts import const

# level-1 tables (16 sign cases over the 6 tet edges; case bit i = occ(v_i))
TRIANGLE_TABLE = np.asarray([
    [-1, -1, -1, -1, -1, -1],
    [1, 0, 2, -1, -1, -1],
    [4, 0, 3, -1, -1, -1],
    [1, 4, 2, 1, 3, 4],
    [3, 1, 5, -1, -1, -1],
    [2, 3, 0, 2, 5, 3],
    [1, 4, 0, 1, 5, 4],
    [4, 2, 5, -1, -1, -1],
    [4, 5, 2, -1, -1, -1],
    [4, 1, 0, 4, 5, 1],
    [3, 2, 0, 3, 5, 2],
    [1, 3, 5, -1, -1, -1],
    [4, 1, 2, 4, 3, 1],
    [3, 0, 4, -1, -1, -1],
    [2, 0, 1, -1, -1, -1],
    [-1, -1, -1, -1, -1, -1],
], np.int32)

NUM_TRIANGLES_TABLE = np.asarray(
    [0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0], np.int32)

# polygon boundary cycle per case (triangles repeat their first vertex)
MESH_EDGE_TABLE = np.asarray([
    [-1, -1, -1, -1],
    [1, 0, 2, 1],
    [4, 0, 3, 4],
    [1, 3, 4, 2],
    [3, 1, 5, 3],
    [2, 5, 3, 0],
    [1, 5, 4, 0],
    [4, 2, 5, 4],
    [4, 5, 2, 4],
    [4, 5, 1, 0],
    [3, 5, 2, 0],
    [1, 3, 5, 1],
    [4, 3, 1, 2],
    [3, 0, 4, 3],
    [2, 0, 1, 2],
    [-1, -1, -1, -1],
], np.int32)

# level-2 cut of a triangle (index = 4*occ(c0) + 2*occ(c1) + occ(c2));
# entries 0..2 corners, 3..5 boundary verts on (c0,c1), (c1,c2), (c2,c0)
TRI_CUT_TABLE = np.asarray([
    [-1, -1, -1, -1, -1, -1],
    [4, 2, 5, -1, -1, -1],
    [3, 1, 4, -1, -1, -1],
    [3, 1, 2, 3, 2, 5],
    [0, 3, 5, -1, -1, -1],
    [0, 3, 4, 0, 4, 2],
    [0, 1, 4, 0, 4, 5],
    [0, 1, 2, -1, -1, -1],
], np.int32)
NUM_TRI_CUT = np.asarray([0, 1, 1, 2, 1, 2, 2, 1], np.int32)

# level-2 cut of a quad (index = 8*occ(c0)+4*occ(c1)+2*occ(c2)+occ(c3));
# entries 0..3 corners, 4..7 boundary verts on (c0,c1) .. (c3,c0)
QUAD_CUT_TABLE = np.asarray([
    [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [6, 3, 7, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [5, 2, 6, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [5, 2, 7, 3, 7, 2, -1, -1, -1, -1, -1, -1],
    [4, 1, 5, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [4, 1, 5, 4, 5, 7, 5, 6, 7, 7, 6, 3],
    [4, 1, 2, 6, 4, 2, -1, -1, -1, -1, -1, -1],
    [4, 1, 2, 7, 4, 2, 7, 2, 3, -1, -1, -1],
    [0, 4, 7, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [0, 4, 6, 3, 0, 6, -1, -1, -1, -1, -1, -1],
    [0, 4, 5, 0, 5, 2, 0, 2, 6, 0, 6, 7],
    [0, 4, 5, 0, 5, 2, 0, 2, 3, -1, -1, -1],
    [0, 1, 5, 7, 0, 5, -1, -1, -1, -1, -1, -1],
    [0, 1, 5, 0, 5, 6, 0, 6, 3, -1, -1, -1],
    [0, 1, 2, 0, 2, 6, 0, 6, 7, -1, -1, -1],
    [0, 1, 2, 0, 2, 3, -1, -1, -1, -1, -1, -1],
], np.int32)
NUM_QUAD_CUT = np.asarray(
    [0, 1, 1, 2, 1, 4, 2, 3, 1, 2, 4, 3, 2, 3, 3, 2], np.int32)


def _cut_ref_tables(table, counts, n_corners):
    """Which corner / boundary slots each cut case references."""
    corner = np.zeros((len(table), 4), bool)
    bnd = np.zeros((len(table), 4), bool)
    for c, row in enumerate(table):
        for e in row[: 3 * counts[c]]:
            if e < n_corners:
                corner[c, e] = True
            else:
                bnd[c, e - n_corners] = True
    return corner, bnd


TRI_CORNER_REF, TRI_BND_REF = _cut_ref_tables(TRI_CUT_TABLE, NUM_TRI_CUT, 3)
QUAD_CORNER_REF, QUAD_BND_REF = _cut_ref_tables(QUAD_CUT_TABLE,
                                                NUM_QUAD_CUT, 4)


class GShellMesh(NamedTuple):
    """Fixed-capacity mesh. Verts: [0, MV) watertight (SDF-crossing)
    vertices, then [MV, MV+4*MT) per-tet boundary vertices."""

    verts: torch.Tensor           # [MV + 4*MT, 3]
    faces: torch.Tensor           # [4*MT, 3] int32
    face_valid: torch.Tensor      # [4*MT] bool
    vert_valid: torch.Tensor      # [MV + 4*MT] bool
    msdf_aug: torch.Tensor        # [MV + 4*MT] coefficient-grad-stopped mSDF
    verts_wt: torch.Tensor        # [MV, 3]
    faces_wt: torch.Tensor        # [2*MT, 3] int32
    face_wt_valid: torch.Tensor   # [2*MT] bool
    msdf_wt: torch.Tensor         # [MV]
    n_cross: torch.Tensor         # crossing-edge count
    n_valid_tets: torch.Tensor    # sign-mixed tet count

    @property
    def n_verts_watertight(self) -> int:
        return self.verts_wt.shape[0]


def _table(a, device):
    return const(a, device)


def _structured_crossing(occ3: torch.Tensor) -> torch.Tensor:
    """Edge-crossing flags of all lattice edges, class-major, by shifted
    slices of the occupancy volume."""
    vx, vy, vz = occ3.shape
    parts = []
    for (dx, dy, dz) in EDGE_CLASSES:
        a = occ3[: vx - dx, : vy - dy, : vz - dz]
        b = occ3[dx:, dy:, dz:]
        parts.append((a != b).reshape(-1))
    return torch.cat(parts)


def _structured_valid_tets(occ3: torch.Tensor) -> torch.Tensor:
    """Sign-mixed flags of all tets (cell-major, 6 per cell)."""
    vx, vy, vz = occ3.shape
    rx, ry, rz = vx - 1, vy - 1, vz - 1
    occ_i = occ3.to(torch.int8)
    per_type = []
    for path in KUHN_PATHS:
        s = None
        for (px, py, pz) in path:
            c = occ_i[px: px + rx, py: py + ry, pz: pz + rz]
            s = c if s is None else s + c
        per_type.append((s > 0) & (s < 4))
    return torch.stack(per_type, dim=-1).reshape(-1)


def _structured_sdf_pairs(sdf3: torch.Tensor):
    vx, vy, vz = sdf3.shape
    pa, pb = [], []
    for (dx, dy, dz) in EDGE_CLASSES:
        pa.append(sdf3[: vx - dx, : vy - dy, : vz - dz].reshape(-1))
        pb.append(sdf3[dx:, dy:, dz:].reshape(-1))
    return torch.cat(pa), torch.cat(pb)


def _gathered_crossing(occ: torch.Tensor, grid: TetGrid) -> torch.Tensor:
    """Edge-crossing flags of an unstructured grid's edges (bool gathers,
    no gradient)."""
    e = grid.edges[: grid.n_edges]
    return occ.index_select(0, e[:, 0]) != occ.index_select(0, e[:, 1])


def _gathered_valid_tets(occ: torch.Tensor, grid: TetGrid) -> torch.Tensor:
    """Sign-mixed flags of an unstructured grid's tets."""
    s = occ.index_select(0, grid.tets.reshape(-1)).view(-1, 4).sum(-1)
    return (s > 0) & (s < 4)


def _stable_denom(d: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """sign(d) * (|d| + eps), zeros -> eps."""
    s = torch.where(d >= 0, 1.0, -1.0)
    return s * (d.abs() + eps)


def _gshell_level1(grid: TetGrid, pos: torch.Tensor, sdf: torch.Tensor,
                   msdf: torch.Tensor, max_verts: int, max_tets: int) -> dict:
    dev = pos.device
    sdf = sdf.reshape(-1).float()
    msdf = msdf.reshape(-1).float()
    MV, MT = max_verts, max_tets
    E = grid.n_edges

    # ---- level 1: vertices on SDF-crossing edges
    occ = sdf > 0
    structured = grid.dims is not None
    if structured:
        occ3 = occ.reshape(grid.vert_dims)
        crossing = _structured_crossing(occ3)
    else:
        crossing = _gathered_crossing(occ, grid)
    vert_slots = first_k_indices(crossing, MV, E)
    vert_ok = vert_slots < E
    vs = vert_slots.long()
    va = grid.edges[vs, 0]            # row E of edges is (0, 0): fill-safe
    vb = grid.edges[vs, 1]
    psm = torch.cat([pos, sdf[:, None], msdf[:, None]], dim=-1)
    rows_a = gather_rows(psm, va)                               # [MV, 5]
    rows_b = gather_rows(psm, vb)
    sdf_a, sdf_b = rows_a[:, 3], rows_b[:, 3]
    denom = _stable_denom(sdf_a - sdf_b)
    zero = torch.zeros((), device=dev)
    wa = torch.where(vert_ok, -sdf_b / denom, zero)   # SDF gradient flows here
    wb = torch.where(vert_ok, sdf_a / denom, zero)
    verts_wt = rows_a[:, :3] * wa[:, None] + rows_b[:, :3] * wb[:, None]
    msdf_wt_grad = rows_a[:, 4] * wa + rows_b[:, 4] * wb
    msdf_wt_stop = rows_a[:, 4] * wa.detach() + rows_b[:, 4] * wb.detach()

    # edge id -> vertex slot (only crossing edges are ever dereferenced;
    # the fill slots all land on the padding entry E)
    edge2slot = torch.zeros((E + 1,), dtype=torch.int64, device=dev)
    edge2slot[vs] = torch.arange(MV, device=dev)

    # ---- level 1: sign-mixed tets -> cases + faces
    T = grid.n_tets
    valid_tet = (_structured_valid_tets(occ3) if structured
                 else _gathered_valid_tets(occ, grid))
    tet_slots = first_k_indices(valid_tet, MT, T)
    tet_ok = tet_slots < T
    tet_slots_c = tet_slots.clamp(0, T - 1).long()
    tets_c = grid.tets[tet_slots_c].long()                     # [MT, 4]
    occ4 = occ[tets_c]
    powers = const((1, 2, 4, 8), dev)
    tcase = (occ4.long() * powers).sum(-1)
    tcase = torch.where(tet_ok, tcase, 0)
    idx_map = edge2slot[grid.tet_edges[tet_slots_c].long()]     # [MT, 6]

    ntri = _table(NUM_TRIANGLES_TABLE, dev).long()[tcase]
    sel = _table(TRIANGLE_TABLE, dev).long()[tcase].clamp(0, 5)
    faces_wt = torch.gather(idx_map, 1, sel).reshape(MT * 2, 3)
    face_wt_valid = (torch.stack([ntri >= 1, ntri >= 2], dim=1).reshape(-1)
                     & tet_ok.repeat_interleave(2))
    faces_wt = torch.where(face_wt_valid[:, None], faces_wt, 0)

    # ---- level 2 (sign-invariant part): boundary verts on the cycle
    cyc_sel = _table(MESH_EDGE_TABLE, dev).long()[tcase].clamp(0, 5)
    cyc = torch.gather(idx_map, 1, cyc_sel)                     # [MT, 4]
    vm = torch.cat([verts_wt, msdf_wt_grad[:, None], msdf_wt_stop[:, None]],
                   dim=-1)
    vm_c = gather_rows(vm, cyc)                                 # [MT, 4, 5]
    m_c = vm_c[..., 3]
    m_c_stop = vm_c[..., 4]
    v_c = vm_c[..., :3]
    # the cycle's next corner, [:, [1, 2, 3, 0]], as a roll (whose backward
    # is a roll, not an index's adds)
    mA, mB = m_c, torch.roll(m_c, -1, 1)
    vA, vB = v_c, torch.roll(v_c, -1, 1)
    same_sign = (torch.sign(mA) + torch.sign(mB)).abs() == 2
    bdenom = mA - mB
    b_ok = (~same_sign) & (bdenom.abs() > 1e-12)
    bdenom = _stable_denom(bdenom)
    bwA = torch.where(b_ok, -mB / bdenom, zero)
    bwB = torch.where(b_ok, mA / bdenom, zero)
    verts_b = vA * bwA[..., None] + vB * bwB[..., None]         # [MT, 4, 3]
    # carried mSDF: stop-gradient values with detached coefficients
    msdf_b = (m_c_stop * bwA.detach()
              + torch.roll(m_c_stop, -1, 1) * bwB.detach())

    verts_wt = torch.where(vert_ok[:, None], verts_wt, zero)
    verts_aug_raw = torch.cat([verts_wt, verts_b.reshape(MT * 4, 3)], dim=0)
    return {
        "MV": MV, "MT": MT, "vert_ok": vert_ok, "verts_wt": verts_wt,
        "msdf_wt_stop": msdf_wt_stop, "faces_wt": faces_wt.int(),
        "face_wt_valid": face_wt_valid, "tet_ok": tet_ok, "ntri": ntri,
        "is_quad": ntri == 2, "cyc": cyc, "m_c": m_c, "msdf_b": msdf_b,
        "verts_aug_raw": verts_aug_raw,
        "n_cross": crossing.sum(), "n_valid_tets": valid_tet.sum(),
    }


def _gshell_level2(lv1: dict, msdf_sign: float) -> GShellMesh:
    MV, MT = lv1["MV"], lv1["MT"]
    tet_ok, ntri, is_quad = lv1["tet_ok"], lv1["ntri"], lv1["is_quad"]
    cyc = lv1["cyc"]
    dev = cyc.device
    m_c = msdf_sign * lv1["m_c"]
    msdf_b = msdf_sign * lv1["msdf_b"]
    msdf_wt_stop = msdf_sign * lv1["msdf_wt_stop"]

    mocc = (m_c > 0).long()
    mi_tri = (mocc * const((4, 2, 1, 0), dev)).sum(-1)
    mi_quad = (mocc * const((8, 4, 2, 1), dev)).sum(-1)
    n_cut = torch.where(is_quad, _table(NUM_QUAD_CUT, dev).long()[mi_quad],
                        _table(NUM_TRI_CUT, dev).long()[mi_tri])
    n_cut = torch.where(tet_ok & (ntri > 0), n_cut, 0)

    # cut-table vertex numbering: tri [c0 c1 c2 b0 b1 b2],
    # quad [c0 c1 c2 c3 b0 b1 b2 b3]
    b_base = MV + torch.arange(MT, device=dev) * 4
    glob_tri = torch.cat(
        [cyc[:, :3], b_base[:, None] + torch.arange(3, device=dev)], dim=1)
    glob_quad = torch.cat(
        [cyc, b_base[:, None] + torch.arange(4, device=dev)], dim=1)
    tri_cut = _table(TRI_CUT_TABLE, dev).long()[mi_tri].clamp(0, 5)
    quad_cut = _table(QUAD_CUT_TABLE, dev).long()[mi_quad].clamp(0, 7)
    faces_tri = torch.cat([torch.gather(glob_tri, 1, tri_cut),
                           torch.zeros((MT, 6), dtype=torch.int64,
                                       device=dev)], dim=1)
    faces_quad = torch.gather(glob_quad, 1, quad_cut)
    faces_aug = torch.where(is_quad[:, None], faces_quad, faces_tri)
    faces_aug = faces_aug.reshape(MT * 4, 3)
    face_id_in_tet = torch.arange(4, device=dev).repeat(MT)
    face_valid = face_id_in_tet < n_cut.repeat_interleave(4)
    faces_aug = torch.where(face_valid[:, None], faces_aug, 0)

    verts_aug_raw = lv1["verts_aug_raw"]
    msdf_aug = torch.cat([msdf_wt_stop, msdf_b.reshape(MT * 4)], dim=0)

    # referenced vertices: boundary slots from the cut tables; corner marks
    # (shared watertight verts) through a sorted-COO count
    alive = tet_ok & (ntri > 0) & (n_cut > 0)
    corner_ref = torch.where(
        is_quad[:, None], _table(QUAD_CORNER_REF, dev)[mi_quad],
        _table(TRI_CORNER_REF, dev)[mi_tri]) & alive[:, None]
    bnd_ref = torch.where(
        is_quad[:, None], _table(QUAD_BND_REF, dev)[mi_quad],
        _table(TRI_BND_REF, dev)[mi_tri]) & alive[:, None]
    corner_ids = torch.where(corner_ref, cyc, MV).reshape(-1)
    cnt = coo_scatter_add(
        corner_ids, torch.ones((corner_ids.shape[0], 1), device=dev), MV + 1)
    wt_mark = cnt[:MV, 0] > 0
    vert_valid = torch.cat([wt_mark & lv1["vert_ok"], bnd_ref.reshape(-1)])
    verts_aug = torch.where(vert_valid[:, None], verts_aug_raw,
                            torch.zeros((), device=dev))
    return GShellMesh(
        verts=verts_aug, faces=faces_aug.int(), face_valid=face_valid,
        vert_valid=vert_valid, msdf_aug=msdf_aug, verts_wt=lv1["verts_wt"],
        faces_wt=lv1["faces_wt"], face_wt_valid=lv1["face_wt_valid"],
        msdf_wt=msdf_wt_stop, n_cross=lv1["n_cross"],
        n_valid_tets=lv1["n_valid_tets"])


def gshell_extract(grid: TetGrid, pos: torch.Tensor, sdf: torch.Tensor,
                   msdf: torch.Tensor, max_verts: int, max_tets: int,
                   msdf_sign: float = 1.0) -> GShellMesh:
    lv1 = _gshell_level1(grid, pos, sdf, msdf, max_verts, max_tets)
    return _gshell_level2(lv1, msdf_sign)


def gshell_extract_pair(grid: TetGrid, pos: torch.Tensor, sdf: torch.Tensor,
                        msdf: torch.Tensor, max_verts: int, max_tets: int):
    """Both split-stage cuts, cloth (mSDF > 0) and body (mSDF < 0), over
    ONE level-1 extraction: the crossing detection, both compactions, the
    row gathers and the boundary-vertex interpolation run once; only the
    per-tet cut tables differ per sign. Bit-identical to two
    ``gshell_extract`` calls (negation is exact and commutes with the
    gathers). Returns (cloth, body, verts_aug_raw): the unmasked shared
    vertex array, to be posed once and masked per half."""
    lv1 = _gshell_level1(grid, pos, sdf, msdf, max_verts, max_tets)
    return (_gshell_level2(lv1, 1.0), _gshell_level2(lv1, -1.0),
            lv1["verts_aug_raw"])


def sdf_reg_loss(sdf: torch.Tensor, grid: TetGrid) -> torch.Tensor:
    """Sign-flip BCE regularizer over the grid edges whose endpoint SDFs
    disagree in sign (masked mean). On an unstructured grid the endpoints
    are row gathers whose backward is the scatter kernel (no float atomics;
    the JAX package indexes, which agrees up to the order of the sums)."""
    if grid.dims is not None:
        a, b = _structured_sdf_pairs(sdf.reshape(grid.vert_dims))
    else:
        e = grid.edges[: grid.n_edges]
        col = sdf.reshape(-1, 1)
        a = gather_rows(col, e[:, 0])[:, 0]
        b = gather_rows(col, e[:, 1])[:, 0]
    mask = torch.sign(a) != torch.sign(b)

    def bce(logit, target):
        return (logit.clamp_min(0) - logit * target
                + torch.log1p(torch.exp(-logit.abs())))

    loss = bce(a, (b > 0).float()) + bce(b, (a > 0).float())
    denom = mask.sum().clamp_min(1)
    return torch.where(mask, loss, torch.zeros((), device=sdf.device)
                       ).sum() / denom
