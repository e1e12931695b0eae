"""Synthetic scene for tests and the on-card run (counterpart of
``d3human_tpu/data/synthetic.py``): the capsule body model, its canonical
state, per-frame poses on a turntable, a look-at camera and the
height-band garment labels of the template's faces.

``SyntheticScene.frame_target`` renders a frame's ground truth (rgb, masks
and normals of the whole body and of its cloth and body parts) with the
oracle rasterizer, in the target schema the stage ticks read;
``CachedTargets`` keeps every frame packed in fp16 on the device instead.
``disc_target`` gives the analytic mask/normal target of the JAX package's
bench, with its cloth/body split, for the bench scenes of
``chip_smoke.py``; ``seq_bench_template`` builds the bench's seq template
(``bench.py:build_seq``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from d3h_bench.reference.models.geometry import SeqTemplate
from d3h_bench.reference.models.smplx.deformer import (
    CanonicalState, SMPLXDeformer,
)
from d3h_bench.reference.models.smplx.model import (
    SMPLXModel, synthetic_body_model,
)
from d3h_bench.reference.ops import mesh_ops
from d3h_bench.reference.ops.rasterizer import (
    barycentrics, interpolate, interpolate_face_attr, rasterize_bruteforce,
    xfm_points,
)
from d3h_bench.reference.pipeline.template import (
    cluster_decimate, midpoint_subdivide_in_bbox, seq_template,
)
from d3h_bench.reference.render.camera import look_at, perspective


@dataclasses.dataclass
class SyntheticScene:
    model: SMPLXModel
    deformer: SMPLXDeformer
    canon: CanonicalState
    pose_params: Dict[str, torch.Tensor]   # per-frame stacks
    mvp: torch.Tensor        # [4, 4]
    mv: torch.Tensor         # [4, 4]
    campos: torch.Tensor     # [3]
    resolution: Tuple[int, int]
    n_frames: int
    garment_faces: np.ndarray   # [F] int64, 0 body / 1 cloth
    # faces, face labels and the normals' flip on the render's device
    _on_device: Optional[tuple] = dataclasses.field(default=None,
                                                    repr=False)

    def frame_target(self, frame_idx: int) -> Dict[str, torch.Tensor]:
        """The ground-truth buffers of frame ``frame_idx`` modulo
        ``n_frames`` (callers pass the raw iteration counter, as the
        reference cycles its frames): all_img / cloth_img / body_img with
        alpha, all_normal and the parts' normals, the camera and a zero
        background. ``frame_idx`` is a Python int in the result."""
        frame_idx = int(frame_idx) % self.n_frames
        out = self._frame_target_impl(frame_idx)
        out["frame_idx"] = frame_idx
        return out

    @torch.no_grad()
    def _frame_target_impl(self, frame_idx: int) -> Dict[str, torch.Tensor]:
        """JAX ``d3human_tpu/data/synthetic.py:61``: the posed body through
        the oracle rasterizer; a position-keyed procedural albedo; normals
        stored y/z-negated, as the reference saves them."""
        pose = self.pose_params
        sl = slice(frame_idx, frame_idx + 1)
        verts, _, _ = self.model.forward(
            betas=pose["shape"], root_pose=pose["root_pose"][sl],
            body_pose=pose["body_pose"][sl], transl=pose["trans"][sl])
        v = verts[0]
        dev = v.device
        if self._on_device is None:          # copied to the device once
            self._on_device = (
                torch.as_tensor(np.asarray(self.model.faces),
                                dtype=torch.int32, device=dev),
                torch.as_tensor(self.garment_faces, dtype=torch.float32,
                                device=dev)[:, None],
                torch.tensor([1.0, -1.0, -1.0], device=dev))
        faces, labels_f, flip = self._on_device
        v_clip = xfm_points(v, self.mvp)
        rast = rasterize_bruteforce(
            v_clip, faces, torch.ones((faces.shape[0],), dtype=torch.bool,
                                      device=dev), self.resolution)
        bary, cover = barycentrics(v_clip, faces, rast, self.resolution)
        alpha = cover[..., None].float()
        normal = interpolate_face_attr(mesh_ops.face_normals(v, faces), rast)
        labels = interpolate_face_attr(labels_f, rast)
        pos = interpolate(v, bary, faces, rast)
        rgb = (0.5 + 0.4 * torch.sin(pos * 7.0)) * alpha
        cloth_a = labels * alpha
        body_a = (1.0 - labels) * alpha
        gt_normal = normal * flip * alpha
        return {
            "frame_idx": frame_idx, "mvp": self.mvp, "mv": self.mv,
            "campos": self.campos,
            "all_img": torch.cat([rgb, alpha], -1),
            "cloth_img": torch.cat([rgb * cloth_a, cloth_a], -1),
            "body_img": torch.cat([rgb * body_a, body_a], -1),
            "all_normal": gt_normal,
            "cloth_normal": gt_normal * cloth_a,
            "body_normal": gt_normal * body_a,
            "background": torch.zeros((*self.resolution, 3), device=dev),
        }


def pack_target(t: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A frame's target as the cache keeps it: [H, W, 8] fp16 of rgb,
    alpha, garment label (the cloth alpha over the alpha where covered;
    the oracle's alpha is binary) and normal."""
    rgb = t["all_img"][..., :3]
    alpha = t["all_img"][..., 3:4]
    labels = torch.where(alpha > 0, t["cloth_img"][..., 3:4]
                         / alpha.clamp_min(1e-8),
                         torch.zeros((), device=alpha.device))
    return torch.cat([rgb, alpha, labels, t["all_normal"]],
                     -1).to(torch.float16)


class CachedTargets:
    """Every frame's ground truth rendered once and kept on the device as
    8 fp16 channels (``pack_target``; JAX
    ``d3human_tpu/data/synthetic.py:112``), the target dict rebuilt from
    them with a few elementwise ops per call."""

    def __init__(self, scene: SyntheticScene):
        self.scene = scene
        self.n_frames = scene.n_frames
        self._cache = torch.stack([
            pack_target(scene._frame_target_impl(i))
            for i in range(scene.n_frames)])

    def _reconstruct(self, packed: torch.Tensor, frame_idx: int
                     ) -> Dict[str, torch.Tensor]:
        p = packed.float()
        rgb, alpha, labels, normal = (p[..., :3], p[..., 3:4], p[..., 4:5],
                                      p[..., 5:8])
        cloth_a = labels * alpha
        body_a = (1.0 - labels) * alpha
        s = self.scene
        return {
            "frame_idx": frame_idx, "mvp": s.mvp, "mv": s.mv,
            "campos": s.campos,
            "all_img": torch.cat([rgb, alpha], -1),
            "cloth_img": torch.cat([rgb * cloth_a, cloth_a], -1),
            "body_img": torch.cat([rgb * body_a, body_a], -1),
            "all_normal": normal,
            "cloth_normal": normal * cloth_a,
            "body_normal": normal * body_a,
            "background": torch.zeros((*s.resolution, 3), device=p.device),
        }

    def frame_target(self, frame_idx: int) -> Dict[str, torch.Tensor]:
        frame_idx = int(frame_idx) % self.n_frames
        return self._reconstruct(self._cache[frame_idx], frame_idx)


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
        mvp=t(proj @ mv), mv=t(mv), campos=t(np.linalg.inv(mv)[:3, 3]),
        resolution=tuple(resolution), n_frames=n_frames,
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
