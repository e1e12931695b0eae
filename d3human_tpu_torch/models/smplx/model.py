"""SMPL-X-layout body model (counterpart of
``d3human_tpu/models/smplx/model.py``): static tables plus ``forward``, and
``synthetic_body_model``, a copy of the JAX package's small capsule
humanoid built from a numpy seed (the licensed SMPL-X npz cannot ship)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from d3human_tpu_torch.models.smplx.lbs import lbs


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
