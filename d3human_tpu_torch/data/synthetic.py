"""Synthetic scene for tests and the on-card run (counterpart of the pose
and camera part of ``d3human_tpu/data/synthetic.py:make_scene``): the
capsule body model, its canonical state, per-frame poses on a turntable,
a look-at camera and the height-band garment labels of the template's
faces. Ground-truth rendering is not ported; ``disc_target`` gives the
analytic mask/normal target of the JAX package's bench, with its cloth/body
split for the split and seq stages; ``seq_bench_template`` builds the
bench's seq template (``bench.py:build_seq``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from d3human_tpu_torch.models.geometry import SeqTemplate
from d3human_tpu_torch.models.smplx.deformer import (
    CanonicalState, SMPLXDeformer,
)
from d3human_tpu_torch.models.smplx.model import (
    SMPLXModel, synthetic_body_model,
)
from d3human_tpu_torch.pipeline.template import (
    cluster_decimate, midpoint_subdivide_in_bbox, seq_template,
)
from d3human_tpu_torch.render.camera import look_at, perspective


@dataclasses.dataclass
class SyntheticScene:
    model: SMPLXModel
    deformer: SMPLXDeformer
    canon: CanonicalState
    pose_params: Dict[str, torch.Tensor]
    mvp: torch.Tensor        # [4, 4]
    campos: torch.Tensor     # [3]
    n_frames: int
    garment_faces: np.ndarray   # [F] int64, 0 body / 1 cloth


def garment_labels(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """1 for the faces whose centroid lies in the torso band
    -0.1 < y < 0.35, else 0."""
    cy = np.asarray(v)[np.asarray(f)][:, :, 1].mean(axis=1)
    return ((cy > -0.1) & (cy < 0.35)).astype(np.int64)


def make_scene(resolution=(128, 128), n_frames: int = 4, seed: int = 0,
               device="cuda") -> SyntheticScene:
    model = synthetic_body_model(seed=seed, device=device)
    deformer = SMPLXDeformer(model)
    betas = torch.zeros((1, model.num_betas), device=device)
    canon = deformer.initialize(betas)

    rng = np.random.default_rng(seed)
    body_pose = np.zeros((n_frames, 63), np.float32)
    body_pose[:, :6] = rng.normal(size=(n_frames, 6)) * 0.1
    root_pose = np.zeros((n_frames, 3), np.float32)
    root_pose[:, 1] = np.linspace(0, 2 * np.pi * (n_frames - 1) / n_frames,
                                  n_frames)
    trans = np.zeros((n_frames, 3), np.float32)
    trans[:, 0] = np.linspace(-0.03, 0.03, n_frames)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    z = lambda n: torch.zeros((n_frames, n), device=device)  # noqa: E731
    pose_params = {
        "shape": betas, "trans": t(trans), "root_pose": t(root_pose),
        "body_pose": t(body_pose), "jaw_pose": z(3), "leye_pose": z(3),
        "reye_pose": z(3), "lhand_pose": z(45), "rhand_pose": z(45),
        "expr": z(model.num_expr),
    }
    mv = look_at(eye=(0.0, 0.0, 2.2), center=(0.0, 0.0, 0.0))
    proj = perspective(fovy=0.9, aspect=resolution[1] / resolution[0])
    return SyntheticScene(
        model=model, deformer=deformer, canon=canon, pose_params=pose_params,
        mvp=t(proj @ mv), campos=t(np.linalg.inv(mv)[:3, 3]),
        n_frames=n_frames,
        garment_faces=garment_labels(model.v_template.cpu().numpy(),
                                     model.faces))


def seq_bench_template(scene: SyntheticScene, n_subdiv: int = 5,
                       target_faces: Optional[int] = 415000,
                       device="cuda") -> SeqTemplate:
    """The JAX bench's seq template (``bench.py:build_seq("full")``): the
    scene's body subdivided ``n_subdiv`` times at edge midpoints,
    cluster-decimated to at most ``target_faces`` (None: not decimated),
    faces labelled by height, a vertex cloth where any cloth face uses it."""
    v = scene.model.v_template.cpu().numpy().astype(np.float32)
    f = np.asarray(scene.model.faces, np.int64)
    big = (np.full(3, -1e9), np.full(3, 1e9))
    for _ in range(n_subdiv):
        v, f = midpoint_subdivide_in_bbox(v, f, big)
    if target_faces is not None and len(f) > target_faces:
        v, f = cluster_decimate(v, f, target_faces=target_faces)
    labels = garment_labels(v, f)
    v_labels = np.zeros(len(v), np.int64)
    v_labels[np.unique(f[labels == 1])] = 1
    return seq_template(v, f, labels, v_labels, device)


def disc_target(resolution: Tuple[int, int], mvp: torch.Tensor,
                campos: torch.Tensor, device="cuda") -> dict:
    """The JAX bench's synthetic target: an elliptic mask disc with a
    striped rgb and a hemispherical normal map, zero background, and the
    split stage's targets: the disc cut at ``yy > 0`` into a cloth and a
    body part (image, mask and normals of each)."""
    H, W = resolution
    yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                         indexing="ij")
    mask = ((xx ** 2 / 0.15 + yy ** 2 / 0.7) < 1).astype(np.float32)[..., None]
    rgb = (0.5 + 0.2 * np.sin(8 * xx))[..., None].repeat(3, -1).astype(
        np.float32) * mask
    nrm = np.stack([xx, yy, np.sqrt(np.clip(1 - xx ** 2 - yy ** 2, 0, 1))],
                   -1).astype(np.float32) * mask

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(device)

    target = {"frame_idx": 0, "mvp": mvp, "campos": campos,
              "all_img": t(np.concatenate([rgb, mask], -1)),
              "all_normal": t(nrm),
              "background": torch.zeros((H, W, 3), device=device)}
    cloth_a = mask * (yy > 0)[..., None]
    for name, a in (("cloth", cloth_a), ("body", mask - cloth_a)):
        target[f"{name}_img"] = t(np.concatenate([rgb * a, a], -1))
        target[f"{name}_normal"] = t(nrm * a)
    return target


def capsule_sdf(verts: torch.Tensor) -> torch.Tensor:
    """Analytic capsule along y (radius 0.24, |y| <= 0.35), positive inside:
    the bench's seed surface for ``GeometryModel.pretrain_sdf``."""
    seg = verts[:, 1].clamp(-0.35, 0.35)
    ax = torch.stack([torch.zeros_like(seg), seg, torch.zeros_like(seg)], -1)
    return 0.24 - torch.linalg.norm(verts - ax, dim=-1)
