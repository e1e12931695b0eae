"""Linear blend skinning (counterpart of ``d3human_tpu/models/smplx/lbs.py``):
shape blendshapes -> joint regression -> pose blendshapes -> kinematic
chain -> skinning. Returns (verts, posed joints, A), A being the per-joint
4x4 rest->posed transforms the deformer needs."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from d3human_tpu_torch.ops.scatter import gather_rows


def batch_rodrigues(rot_vecs: torch.Tensor,
                    epsilon: float = 1e-8) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3]."""
    angle = torch.linalg.norm(rot_vecs + epsilon, dim=-1, keepdim=True)
    rot_dir = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = rot_dir[..., 0], rot_dir[..., 1], rot_dir[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                    dim=-1).reshape(rot_vecs.shape[:-1] + (3, 3))
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return ident + sin * K + (1.0 - cos) * (K @ K)


def transform_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """R [..., 3, 3], t [..., 3] -> homogeneous [..., 4, 4]."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents: Tuple[int, ...]):
    """Kinematic chain. Returns (posed_joints [B,J,3], A [B,J,4,4])."""
    parents = tuple(int(p) for p in parents)
    B, J = joints.shape[:2]
    # the parents' joints by a row gather (a joint is the parent of several:
    # the backward adds in the scatter's fixed order)
    by_joint = joints.transpose(0, 1).reshape(J, B * 3)
    parent_joints = gather_rows(by_joint, torch.tensor(
        parents[1:], device=joints.device)).reshape(J - 1, B, 3)
    rel_joints = joints - torch.cat(
        [torch.zeros_like(joints[:, :1]), parent_joints.transpose(0, 1)],
        dim=1)
    transforms_mat = transform_mat(rot_mats, rel_joints)
    chain = [transforms_mat[:, 0]]
    for i in range(1, len(parents)):
        chain.append(chain[parents[i]] @ transforms_mat[:, i])
    transforms = torch.stack(chain, dim=1)
    posed_joints = transforms[:, :, :3, 3]
    joints_homo = torch.cat([joints, torch.zeros_like(joints[..., :1])],
                            dim=-1)
    correction = torch.einsum("bjrc,bjc->bjr", transforms, joints_homo)
    rel = torch.cat([transforms[..., :3],
                     (transforms[..., 3] - correction)[..., None]], dim=-1)
    return posed_joints, rel


def lbs(betas: torch.Tensor, pose: torch.Tensor, v_template: torch.Tensor,
        shapedirs: torch.Tensor, posedirs: torch.Tensor,
        J_regressor: torch.Tensor, parents: Tuple[int, ...],
        lbs_weights: torch.Tensor,
        joint_offset: Optional[torch.Tensor] = None,
        locator_offset: Optional[torch.Tensor] = None):
    """Full LBS with axis-angle pose. Returns (verts, posed_joints, A)."""
    B = max(betas.shape[0], pose.shape[0])
    if v_template.dim() == 2:
        v_template = v_template[None]
    v_shaped = v_template + torch.einsum("bl,vkl->bvk", betas, shapedirs)
    J = torch.einsum("bvk,jv->bjk", v_shaped, J_regressor)
    if joint_offset is not None:
        J = J + joint_offset
    chain_joints = J + locator_offset if locator_offset is not None else J
    ident = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    rot_mats = batch_rodrigues(pose.reshape(B, -1, 3))
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    v_posed = v_shaped + (pose_feature @ posedirs).reshape(B, -1, 3)
    J_transformed, A = batch_rigid_transform(rot_mats, chain_joints, parents)
    T = torch.einsum("vj,bjrc->bvrc", lbs_weights, A)
    v_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvrc,bvc->bvr", T, v_homo)[..., :3]
    return verts, J_transformed, A
