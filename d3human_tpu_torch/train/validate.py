"""Validation strips and metrics (counterpart of
``d3human_tpu/train/validate.py``): the current geometry rendered by the
full path against the target, tiled into rows of panels [opt RGB | ref
RGB | masks | normals | mSDF | depth | mask overlap], the overlap coded
red = reference only, green = render only, yellow = both (ref
train.py:337-537). Renders run without gradients; strips come back as
float numpy arrays."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from d3human_tpu_torch.config import Config
from d3human_tpu_torch.models.geometry import GeometryModel, SeqTemplate
from d3human_tpu_torch.ops.image_loss import rgb_to_srgb
from d3human_tpu_torch.render.pipeline import MeshBuffers, render_mesh
from d3human_tpu_torch.train.losses import render_stage_mesh
from d3human_tpu_torch.utils.metrics import iou, psnr


def combine_mask(ref: torch.Tensor, opt: torch.Tensor) -> torch.Tensor:
    """[H, W, 3]: red where ``ref`` covers, green where ``opt`` does."""
    img = torch.zeros(ref.shape[:2] + (3,), device=ref.device)
    img[..., 0] = (ref[..., 0] > 0).float()
    img[..., 1] = (opt[..., 0] > 0).float()
    return img


def _gray3(x: torch.Tensor) -> torch.Tensor:
    return x[..., :1].expand(*x.shape[:-1], 3)


def _norm_display(n: torch.Tensor) -> torch.Tensor:
    n = n[..., :3] * torch.tensor([1.0, -1.0, -1.0], device=n.device)
    return (n + 1.0) / 2.0


def _strip(rows) -> np.ndarray:
    return torch.cat([torch.cat(r, dim=1) for r in rows],
                     dim=0).cpu().numpy()


def validation_strip(buffers: MeshBuffers, target: Dict) -> np.ndarray:
    """One row of panels (ref validate_itr layout, train.py:424-438)."""
    gt = target["all_img"]
    return _strip([[
        rgb_to_srgb(buffers.shaded[..., :3].clamp(0, 1)),
        rgb_to_srgb(gt[..., :3].clamp(0, 1)),
        _gray3(buffers.shaded[..., 3:]),
        _gray3(gt[..., 3:]),
        _norm_display(buffers.geometric_normal),
        (target["all_normal"][..., :3] + 1.0) / 2.0,
        _gray3(buffers.msdf_image).clamp(0, 1),
        combine_mask(gt[..., 3:], buffers.shaded[..., 3:]),
    ]])


def depth_display(buffers: MeshBuffers) -> torch.Tensor:
    """The depth normalised to [0, 1] over the image (ref
    train.py:378-383)."""
    d = buffers.depth[..., :1]
    nd = (d - d.min()) / torch.clamp_min(d.max() - d.min(), 1e-8)
    return torch.nan_to_num(_gray3(nd))


def validate_stage(generator, model: GeometryModel, params: Dict,
                   tex_module, target: Dict, cfg: Config,
                   msdf_sign: float = 1.0, raster_opts=None,
                   return_buffers: bool = False):
    """The strip of one extraction (the init stage's), and its buffers
    with ``return_buffers``."""
    with torch.no_grad():
        _, buffers = render_stage_mesh(
            generator, model, params["geometry"], params["pose"],
            tex_module, params["material"], target, cfg,
            msdf_sign=msdf_sign, raster_opts=raster_opts, compact=False)
    strip = validation_strip(buffers, target)
    return (strip, buffers) if return_buffers else strip


def validate_split_stage(generator, model: GeometryModel, params: Dict,
                         tex_module, target: Dict, cfg: Config,
                         raster_opts=None):
    """Both split halves (cloth mSDF sign +1, body -1) rendered and
    composited by depth, so PSNR and mask IoU are measured against the
    whole person; the per-half IoUs against the halves' masks. Rows: the
    union, the cloth half, the body half. Returns (strip, metrics)."""
    with torch.no_grad():
        bufs = {name: render_stage_mesh(
            generator, model, params["geometry"], params["pose"],
            tex_module, params["material"], target, cfg, msdf_sign=sign,
            raster_opts=raster_opts, compact=False)[1]
            for name, sign in (("cloth", 1.0), ("body", -1.0))}
    buf_c, buf_b = bufs["cloth"], bufs["body"]
    a_c, a_b = buf_c.shaded[..., 3:], buf_b.shaded[..., 3:]
    inf = torch.tensor(float("inf"), device=a_c.device)
    z_c = torch.where(a_c[..., 0] > 0.5, buf_c.depth[..., 0], inf)
    z_b = torch.where(a_b[..., 0] > 0.5, buf_b.depth[..., 0], inf)
    rgb = torch.where((z_c <= z_b)[..., None], buf_c.shaded[..., :3],
                      buf_b.shaded[..., :3])
    alpha = torch.maximum(a_c, a_b)
    gt = target["all_img"]
    metrics = {
        "psnr": float(psnr(rgb * gt[..., 3:], gt[..., :3] * gt[..., 3:])),
        "mask_iou": float(iou(alpha[..., 0] > 0.5, gt[..., 3] > 0.5)),
    }
    if "body_img" in target:
        metrics["body_iou"] = float(
            iou(a_b[..., 0] > 0.5, target["body_img"][..., 3] > 0.5))
    if "cloth_img" in target:
        metrics["cloth_iou"] = float(
            iou(a_c[..., 0] > 0.5, target["cloth_img"][..., 3] > 0.5))
    union = [
        rgb_to_srgb(rgb.clamp(0, 1)),
        rgb_to_srgb(gt[..., :3].clamp(0, 1)),
        _gray3(alpha), _gray3(gt[..., 3:]), _gray3(a_b), _gray3(a_c),
        combine_mask(gt[..., 3:], alpha),
    ]

    def half_row(buf, part):
        gt_part = target.get(f"{part}_img", gt)
        gt_nrm = target.get(f"{part}_normal", target.get("all_normal"))
        return [
            rgb_to_srgb(buf.shaded[..., :3].clamp(0, 1)),
            rgb_to_srgb(gt_part[..., :3].clamp(0, 1)),
            _norm_display(buf.geometric_normal),
            (gt_nrm[..., :3] + 1.0) / 2.0 if gt_nrm is not None
            else torch.zeros_like(buf.shaded[..., :3]),
            _gray3(buf.msdf_image).clamp(0, 1),
            depth_display(buf),
            combine_mask(gt_part[..., 3:], buf.shaded[..., 3:]),
        ]

    return (_strip([union, half_row(buf_c, "cloth"),
                    half_row(buf_b, "body")]), metrics)


def validate_seq_stage(generator, model: GeometryModel, params: Dict,
                       tex_module, template: SeqTemplate, target: Dict,
                       cfg: Config, raster_opts=None):
    """The posed seq template through the full path with its face labels,
    split into cloth and body by the mesh-id buffer (ref
    validate_itr_all). Rows: union, cloth, body; columns [opt | ref RGB |
    opt mask | ref mask | normal | ref normal or depth | mask overlap].
    Returns (strip, metrics): union psnr / mask_iou and per-part IoUs."""
    with torch.no_grad():
        posed, _ = model.seq_deformed(params["geometry"], template,
                                      params["pose"],
                                      int(target["frame_idx"]))
        buf = render_mesh(
            generator, posed, template.v, template.f,
            torch.ones((template.f.shape[0],), dtype=torch.bool,
                       device=posed.device),
            target["mvp"], target["campos"], tuple(cfg.render.train_res),
            tex_module, params["material"], target["background"],
            face_labels=template.face_labels, spp=cfg.render.spp,
            raster_opts=raster_opts,
            max_covered_frac=cfg.render.max_covered_frac, compact=False)
    alpha, vl = buf.alpha, buf.mesh_id
    part_mask = {"cloth": vl * alpha, "body": (1.0 - vl) * alpha}
    gt = target["all_img"]
    metrics = {
        "psnr": float(psnr(buf.shaded[..., :3] * gt[..., 3:],
                           gt[..., :3] * gt[..., 3:])),
        "mask_iou": float(iou(alpha[..., 0] > 0.5, gt[..., 3] > 0.5)),
    }
    for part, m in part_mask.items():
        tp = target.get(f"{part}_img")
        if tp is not None:
            metrics[f"{part}_iou"] = float(iou(m[..., 0] > 0.5,
                                               tp[..., 3] > 0.5))
    depth_panel = depth_display(buf)
    gt_nrm = target.get("all_normal")
    union = [
        rgb_to_srgb(buf.shaded[..., :3].clamp(0, 1)),
        rgb_to_srgb(gt[..., :3].clamp(0, 1)),
        _gray3(alpha), _gray3(gt[..., 3:]),
        _norm_display(buf.geometric_normal),
        (gt_nrm[..., :3] + 1.0) / 2.0 if gt_nrm is not None
        else torch.zeros_like(buf.shaded[..., :3]),
        combine_mask(gt[..., 3:], alpha),
    ]

    def part_row(part):
        m = part_mask[part]
        tp = target.get(f"{part}_img", gt)
        return [
            rgb_to_srgb((buf.shaded[..., :3] * m).clamp(0, 1)),
            rgb_to_srgb(tp[..., :3].clamp(0, 1)),
            _gray3(m), _gray3(tp[..., 3:]),
            _norm_display(buf.geometric_normal) * m,
            depth_panel,
            combine_mask(tp[..., 3:], m),
        ]

    return _strip([union, part_row("cloth"), part_row("body")]), metrics
