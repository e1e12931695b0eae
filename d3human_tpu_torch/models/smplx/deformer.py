"""SMPL-X articulated deformer (counterpart of
``d3human_tpu/models/smplx/deformer.py``): the canonical A-pose template,
K=1 skinning-weight transfer, and ``lbs_forward`` — canonicalize points
w.r.t. the template's transforms, then re-pose with the frame's."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from d3human_tpu_torch.models.smplx.model import SMPLXModel
from d3human_tpu_torch.ops.knn import knn1
from d3human_tpu_torch.utils.consts import const
from d3human_tpu_torch.utils.logging import span


@dataclasses.dataclass(frozen=True)
class CanonicalState:
    vs_template: torch.Tensor   # [1, V, 3] canonical A-pose verts
    init_A: torch.Tensor        # [1, J, 4, 4]


class SMPLXDeformer:
    def __init__(self, model: SMPLXModel):
        self.model = model

    def initialize(self, betas: torch.Tensor) -> CanonicalState:
        """Zero pose except a +-pi/36 hip spread (ref deformer.py:178-180)."""
        B = betas.shape[0]
        body_pose = torch.zeros((B, 63), dtype=betas.dtype,
                                device=betas.device)
        body_pose[:, 2] = math.pi / 36
        body_pose[:, 5] = -math.pi / 36
        verts, _, A = self.model.forward(
            betas=betas, root_pose=torch.zeros((B, 3), dtype=betas.dtype,
                                               device=betas.device),
            body_pose=body_pose)
        return CanonicalState(vs_template=verts, init_A=A)

    def interpolate_weights(self, canon: CanonicalState,
                            pts: torch.Tensor) -> torch.Tensor:
        """[P, 3] -> [P, J]: the nearest template vertex's weights (K=1,
        where the JAX package's inverse-distance blend is exactly 1). The
        range ``d3h.smplx.skin_weights`` under a profiler: the seq step's
        transfer, and the same one in init and split at the extracted
        mesh's vertices."""
        with span("d3h.smplx.skin_weights"):
            _, idx = knn1(pts, canon.vs_template[0])
            return self.model.lbs_weights[idx]

    @staticmethod
    def _affine_inverse(M: torch.Tensor) -> torch.Tensor:
        """Closed-form inverse of affine [..., 4, 4] transforms (adjugate)."""
        R = M[..., :3, :3]
        t = M[..., :3, 3]
        c0 = torch.linalg.cross(R[..., :, 1], R[..., :, 2], dim=-1)
        c1 = torch.linalg.cross(R[..., :, 2], R[..., :, 0], dim=-1)
        c2 = torch.linalg.cross(R[..., :, 0], R[..., :, 1], dim=-1)
        det = (R[..., :, 0] * c0).sum(-1, keepdim=True)
        det = torch.where(det.abs() < 1e-12, 1e-12, det)
        Rinv = torch.stack([c0, c1, c2], dim=-2) / det[..., None]
        tinv = -torch.einsum("...rc,...c->...r", Rinv, t)
        top = torch.cat([Rinv, tinv[..., :, None]], dim=-1)
        bottom = const((0.0, 0.0, 0.0, 1.0), M.device, M.dtype).expand(
            top.shape[:-2] + (1, 4))
        return torch.cat([top, bottom], dim=-2)

    @staticmethod
    def apply_lbs_inverse(pts: torch.Tensor, A: torch.Tensor,
                          w_pts: torch.Tensor,
                          inverse: bool = True) -> torch.Tensor:
        """Map pts [P,3] by (sum_j w_j A_j)^{+-1}."""
        M = torch.einsum("pj,jrc->prc", w_pts, A[0])
        if inverse:
            M = SMPLXDeformer._affine_inverse(M)
        pts_h = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=-1)
        return torch.einsum("prc,pc->pr", M, pts_h)[:, :3]

    def lbs_forward(self, canon: CanonicalState, pts: torch.Tensor,
                    smplx_params: Dict[str, torch.Tensor],
                    frame_idx: int,
                    w_pts: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Canonicalize pts w.r.t. init_A, re-pose with the frame's
        transforms and add its translation (ref deformer.py:434-486).
        ``w_pts`` [P, J] skips the weight transfer with given weights."""
        def frame(name, d):
            return smplx_params[name][frame_idx].reshape(1, d)

        nb, ne = self.model.num_betas, self.model.num_expr
        trans = frame("trans", 3)
        _, _, A = self.model.forward(
            betas=smplx_params["shape"].reshape(1, -1)[:, :nb],
            root_pose=frame("root_pose", 3),
            body_pose=frame("body_pose", 63),
            jaw_pose=frame("jaw_pose", 3),
            leye_pose=frame("leye_pose", 3),
            reye_pose=frame("reye_pose", 3),
            lhand_pose=frame("lhand_pose", 45),
            rhand_pose=frame("rhand_pose", 45),
            expression=frame("expr", ne),
            transl=trans,
            face_offset=smplx_params.get("face_offset"),
            joint_offset=smplx_params.get("joint_offset"),
            locator_offset=smplx_params.get("locator_offset"))
        if w_pts is None:
            w_pts = self.interpolate_weights(canon, pts)
        pts_c = self.apply_lbs_inverse(pts, canon.init_A, w_pts, inverse=True)
        pts_new = self.apply_lbs_inverse(pts_c, A, w_pts, inverse=False)
        return pts_new + trans.reshape(1, 3)
