"""SMPL-X-layout body model (counterpart of
``d3human_tpu/models/smplx/model.py``): static tables plus ``forward``;
the loaders of the official npz releases (``load_smplx_npz`` and
``create`` for SMPL, SMPL+H, SMPL-X, MANO and FLAME); and
``synthetic_body_model``, a copy of the JAX package's small capsule
humanoid built from a numpy seed (the licensed SMPL-X npz cannot ship)."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from d3h_bench.reference.models.smplx.lbs import lbs

# SMPL-X joint layout (public model topology): 55 joints
SMPLX_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    15, 15, 15,                                    # jaw, leye, reye
    20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,  # left hand
    21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,  # right hand
)


@dataclasses.dataclass(frozen=True)
class SMPLXModel:
    v_template: torch.Tensor     # [V, 3]
    shapedirs: torch.Tensor      # [V, 3, n_betas + n_expr]
    posedirs: torch.Tensor       # [(J-1)*9, V*3]
    J_regressor: torch.Tensor    # [J, V]
    lbs_weights: torch.Tensor    # [V, J]
    faces: np.ndarray            # [F, 3] int (host)
    parents: Tuple[int, ...]
    num_betas: int
    num_expr: int

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    def forward(self, betas, root_pose, body_pose, jaw_pose=None,
                leye_pose=None, reye_pose=None, lhand_pose=None,
                rhand_pose=None, expression=None,
                transl: Optional[torch.Tensor] = None,
                face_offset: Optional[torch.Tensor] = None,
                joint_offset: Optional[torch.Tensor] = None,
                locator_offset: Optional[torch.Tensor] = None):
        """Returns (verts [B,V,3], joints [B,J,3], A [B,J,4,4]); the pose
        vector [root, body, jaw, leye, reye, lhand, rhand] is cut to the
        model's joint count. ``face_offset`` [B,V,3] moves the template
        before the blendshapes, ``joint_offset`` / ``locator_offset``
        [B,J,3] the regressed joints and the chain's joints."""
        B = betas.shape[0]
        J = self.num_joints

        def z(x, n):
            return (torch.zeros((B, n), dtype=betas.dtype,
                                device=betas.device) if x is None else x)

        full_pose = torch.cat(
            [root_pose, body_pose, z(jaw_pose, 3), z(leye_pose, 3),
             z(reye_pose, 3), z(lhand_pose, 45), z(rhand_pose, 45)],
            dim=1)[:, : J * 3]
        shape = torch.cat([betas, z(expression, self.num_expr)], dim=-1)
        shape = shape[:, : self.shapedirs.shape[-1]]
        v_template = self.v_template[None]
        if face_offset is not None:
            v_template = v_template + face_offset
        verts, joints, A = lbs(shape, full_pose, v_template,
                               self.shapedirs, self.posedirs,
                               self.J_regressor, self.parents,
                               self.lbs_weights, joint_offset=joint_offset,
                               locator_offset=locator_offset)
        if transl is not None:
            verts = verts + transl[:, None, :]
            joints = joints + transl[:, None, :]
        return verts, joints, A


def _model(data, shapedirs, parents, num_betas, num_expr,
           device) -> SMPLXModel:
    """The model of an npz's tables; posedirs [V, 3, P] become [P, V*3]."""
    posedirs = np.asarray(data["posedirs"], np.float32)
    if posedirs.ndim == 3:
        posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    return SMPLXModel(
        v_template=t(data["v_template"]), shapedirs=t(shapedirs),
        posedirs=t(posedirs), J_regressor=t(data["J_regressor"]),
        lbs_weights=t(data["weights"]),
        faces=np.asarray(data["f"], np.int64), parents=parents,
        num_betas=num_betas, num_expr=num_expr)


def load_smplx_npz(model_path: str, gender: str = "neutral",
                   num_betas: int = 100, num_expr: int = 50,
                   device="cuda") -> SMPLXModel:
    """The official SMPL-X npz, ``model_path``/SMPLX_<GENDER>.npz:
    shapedirs [V, 3, 300 + expression] (shape columns, then the expression
    columns from 300), posedirs [V, 3, P], ``kintree_table`` [2, J] (the
    parents as stored, SMPL-X's own without it)."""
    fn = os.path.join(model_path, f"SMPLX_{gender.upper()}.npz")
    data = np.load(fn, allow_pickle=True)
    shapedirs = np.asarray(data["shapedirs"], np.float32)
    n_shape = min(num_betas, 300)
    sd = np.concatenate(
        [shapedirs[:, :, :n_shape], shapedirs[:, :, 300:300 + num_expr]],
        axis=-1) if shapedirs.shape[-1] > 300 else shapedirs[:, :, :n_shape]
    parents = (tuple(int(p) for p in np.asarray(data["kintree_table"])[0])
               if "kintree_table" in data else SMPLX_PARENTS)
    return _model(data, sd, parents, n_shape, num_expr, device)


def _load_generic_npz(fn: str, num_betas: int, num_expr: int,
                      expr_offset: int, device="cuda") -> SMPLXModel:
    """The npz of any body-model family. ``expr_offset`` is the column of
    shapedirs where the expression starts (300 for SMPL-X and FLAME, 0
    for the families without one); the root's parent is -1 whatever the
    file stores (the official files store uint32 -1)."""
    data = np.load(fn, allow_pickle=True)
    shapedirs = np.asarray(data["shapedirs"], np.float32)
    n_cols = shapedirs.shape[-1]
    if expr_offset and n_cols > expr_offset:
        n_shape = min(num_betas, expr_offset)
        sd = np.concatenate(
            [shapedirs[:, :, :n_shape],
             shapedirs[:, :, expr_offset:expr_offset + num_expr]], axis=-1)
        ne = min(num_expr, n_cols - expr_offset)
    else:
        n_shape = min(num_betas, n_cols)
        sd = shapedirs[:, :, :n_shape]
        ne = 0
    parents = tuple(
        int(p) if i else -1
        for i, p in enumerate(np.asarray(data["kintree_table"])[0])
    ) if "kintree_table" in data else SMPLX_PARENTS
    return _model(data, sd, parents, n_shape, ne, device)


# family -> (file name, default num_betas, num_expr, expression column)
_BODY_MODEL_FAMILIES = {
    "smpl": ("SMPL_{G}.npz", 10, 0, 0),
    "smplh": ("SMPLH_{G}.npz", 16, 0, 0),
    "smplx": ("SMPLX_{G}.npz", 100, 50, 300),
    "mano": ("MANO_{G}.npz", 10, 0, 0),       # gender slot: RIGHT / LEFT
    "flame": ("FLAME_{G}.npz", 300, 100, 300),
}


def create(model_path: str, model_type: str = "smplx",
           gender: str = "neutral", num_betas: Optional[int] = None,
           num_expr: Optional[int] = None, device="cuda") -> SMPLXModel:
    """The body model of family ``model_type`` (ref body_models.py:2380-2442
    ``create``) from its npz release, looked up in
    ``model_path``/<model_type>/ first, then in ``model_path``. Every
    family runs the same skinning: ``forward`` cuts the pose to the
    family's joint count. The .pkl releases are not read."""
    mt = model_type.lower()
    if mt not in _BODY_MODEL_FAMILIES:
        raise ValueError(f"unknown model_type {model_type!r}; expected one "
                         f"of {sorted(_BODY_MODEL_FAMILIES)}")
    pat, d_betas, d_expr, off = _BODY_MODEL_FAMILIES[mt]
    fname = pat.format(G=gender.upper())
    for cand in (os.path.join(model_path, mt, fname),
                 os.path.join(model_path, fname)):
        if os.path.exists(cand):
            return _load_generic_npz(
                cand, num_betas if num_betas is not None else d_betas,
                num_expr if num_expr is not None else d_expr, off, device)
    raise FileNotFoundError(
        f"no {fname} under {model_path!r} (tried '{mt}/' and flat)")


def synthetic_body_model(n_theta: int = 24, n_phi: int = 12,
                         num_betas: int = 10, num_expr: int = 4,
                         seed: int = 0, device="cuda") -> SMPLXModel:
    """Capsule torso humanoid with a 9-joint tree (numbers identical to the
    JAX package's ``synthetic_body_model`` for the same arguments)."""
    rng = np.random.default_rng(seed)
    ring_t = np.linspace(-0.6, 0.6, n_theta)
    ang = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    verts = []
    for y in ring_t:
        r = 0.18 * np.sqrt(np.clip(1.0 - (abs(y) / 0.62) ** 4, 0.05, 1.0))
        for a in ang:
            verts.append([r * np.cos(a), y, r * np.sin(a)])
    verts = np.asarray(verts, np.float32)
    V = len(verts)

    faces = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            faces.append([a, b, c])
            faces.append([b, d, c])
    faces = np.asarray(faces, np.int64)

    J = 9
    parents = (-1, 0, 1, 2, 3, 2, 5, 2, 7)
    joint_pos = np.asarray([
        [0, -0.45, 0], [0, -0.15, 0], [0, 0.15, 0], [0, 0.40, 0],
        [0, 0.55, 0], [-0.15, 0.35, 0], [-0.3, 0.35, 0],
        [0.15, 0.35, 0], [0.3, 0.35, 0],
    ], np.float32)
    d = np.linalg.norm(verts[None, :, :] - joint_pos[:, None, :], axis=-1)
    J_regressor = np.exp(-d / 0.05)
    J_regressor /= J_regressor.sum(axis=1, keepdims=True)
    w = np.exp(-(d.T / 0.12) ** 2)
    lbs_weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    shapedirs = (rng.normal(size=(V, 3, num_betas + num_expr))
                 * 0.01).astype(np.float32)
    posedirs = (rng.normal(size=((J - 1) * 9, V * 3)) * 0.001).astype(
        np.float32)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    return SMPLXModel(
        v_template=t(verts), shapedirs=t(shapedirs), posedirs=t(posedirs),
        J_regressor=t(J_regressor), lbs_weights=t(lbs_weights), faces=faces,
        parents=parents, num_betas=num_betas, num_expr=num_expr)
