"""Loss ticks of the init, split and seq stages (counterpart of
``d3human_tpu/train/losses.py``: ``tick_init``, ``tick_split_one``,
``tick_split``, ``tick_seq``; ref hmsdf.py:810-1182 with the training
loops' totals at train.py:718, :1040-1087 and :1412-1421). Every tick
renders the current geometry and returns a dict of named losses.

init:  mask MSE x100, the rendered-mSDF hinges (log-only), eikonal on
       surface samples (a double backward), the annealed sign-flip
       regularizer and the x50 perceptual normal loss.
split: per half (cloth mSDF > 0, body mSDF < 0, one shared extraction) the
       tonemapped image loss + hinges, mask MSE x10, eikonal, sign-flip
       regularizer, material smoothness + chroma, the x5 perceptual normal
       loss on a random crop; the mesh-mSDF open/close regularizer is
       log-only.
seq:   the nonrigid DeformMLP's offsets on the merged template + LBS, the
       shaded render with the face labels, the mask split into cloth and
       body by the per-pixel label, three mask and three image losses, the
       shading regularizers, the offsets' squared sum, the x20 perceptual
       normal loss, the Laplacian, normal-consistency and collision losses.

Random numbers come from ``generator`` unless ``draws`` injects them: a dict
with ``"eik": (u [n], uv [n, 2])`` uniform draws of the eikonal sampler,
``"render": (n_tex, n_uv)`` standard normals of the render's jitter taps
and ``"crop": (top, left)``; ``tick_split`` takes one such dict per half,
``{"cloth": ..., "body": ...}``; ``tick_seq`` only ``"render"``."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from d3human_tpu_torch.config import Config
from d3human_tpu_torch.models.geometry import (
    GeometryModel, SeqTemplate, collision_loss,
)
from d3human_tpu_torch.models.perceptual import (
    ConvPerceptual, random_crop_pair,
)
from d3human_tpu_torch.ops import mesh_ops
from d3human_tpu_torch.ops.image_loss import make_loss_fn
from d3human_tpu_torch.ops.marching_tets import sdf_reg_loss
from d3human_tpu_torch.ops.scatter import coo_scatter_add, gather_rows
from d3human_tpu_torch.render import regularizer
from d3human_tpu_torch.render.pipeline import MeshBuffers, render_mesh
from d3human_tpu_torch.utils.consts import const
from d3human_tpu_torch.utils.logging import span


def _huber_sum(x: torch.Tensor, target: float, mask=None) -> torch.Tensor:
    """F.huber_loss(delta=1, reduction='sum') against a constant."""
    d = x - target
    loss = torch.where(d.abs() < 1.0, 0.5 * d * d, d.abs() - 0.5)
    if mask is not None:
        loss = torch.where(mask, loss, torch.zeros((), device=x.device))
    return loss.sum()


def eikonal_coeff(it: int, scale: Optional[float]) -> float:
    """ref hmsdf.py:861-872 schedule."""
    if scale is not None:
        return float(scale)
    return 3e-1 if it < 500 else (1e-1 if it < 2000 else 1e-2)


def eikonal_loss(model: GeometryModel, params, pts: torch.Tensor, it: int,
                 cfg: Config) -> torch.Tensor:
    """||grad sdf|| -> 1 at the samples; the gradient keeps its graph
    (create_graph) so the loss differentiates into the MLP weights."""
    differentiable = torch.is_grad_enabled()
    with torch.enable_grad():      # the inner gradient, also under no_grad
        pts = pts.detach().requires_grad_(True)
        s = model.query_sdf(params, pts).sum()
        (g,) = torch.autograd.grad(s, pts, create_graph=differentiable)
    coeff = eikonal_coeff(it, cfg.loss.eikonal_scale)
    return coeff * ((torch.sqrt((g * g).sum(-1) + 1e-12) - 1.0) ** 2).mean()


def _normal_images(buffers: MeshBuffers, normal_ref: torch.Tensor):
    """Unit normals with the reference's y/z negation, mapped to [0, 1]."""
    flip = const((1.0, -1.0, -1.0), normal_ref.device)
    out_n = mesh_ops.safe_normalize(buffers.geometric_normal[..., 0:3]) * flip
    ref_n = mesh_ops.safe_normalize(normal_ref[..., 0:3])
    return (out_n + 1.0) / 2.0, (ref_n + 1.0) / 2.0


def msdf_image_hinges(buffers: MeshBuffers, gt_mask: torch.Tensor):
    """Rendered mSDF pushed negative outside the mask, toward 1 inside."""
    msdf_img = buffers.msdf_image
    outside = (gt_mask == 0).float()
    inside = (gt_mask == 1).float()
    l_out = (msdf_img.clamp_min(0.0) * outside).abs().mean()
    l_in = (msdf_img.clamp_max(0.0) * inside - 1.0).abs().mean()
    return 5e-1 * l_out + 5e-1 * l_in


def mask_iou(pred_alpha, gt_mask):
    p = pred_alpha > 0.5
    g = gt_mask > 0.5
    inter = (p & g).sum().float()
    union = (p | g).sum().float()
    return inter / union.clamp_min(1.0)


def render_stage_mesh(generator, model: GeometryModel, params, pose_params,
                      tex_module, tex_params, target: dict, cfg: Config,
                      msdf_sign: float = 1.0, raster_opts=None, compact=None,
                      shade: bool = True, meshes=None,
                      need_smoothness: bool = True, draws=None):
    """Extract + render. Texture coordinates are the UNPOSED template
    positions. ``meshes`` reuses a shared extraction (the split stage
    extracts both halves at once); ``compact=False`` is the validation
    render through the full path with ``cfg.render.layers``."""
    if meshes is None:
        meshes = model.get_meshes(params, pose_params,
                                  int(target["frame_idx"]),
                                  msdf_sign=msdf_sign)
    r = cfg.render
    buffers = render_mesh(
        generator, meshes.verts_posed, meshes.verts_template,
        meshes.mesh.faces, meshes.mesh.face_valid, target["mvp"],
        target["campos"], tuple(r.train_res), tex_module, tex_params,
        target["background"], msdf_attr=meshes.mesh.msdf_aug, spp=r.spp,
        raster_opts=raster_opts, max_covered_frac=r.max_covered_frac,
        jitter_subsample=r.jitter_subsample, aa_dense=r.aa_dense,
        compact=compact, shade=shade, layers=r.layers,
        need_smoothness=need_smoothness, draws=draws)
    return meshes, buffers


def capacity_metrics(buffers: MeshBuffers, meshes=None) -> dict:
    """Static-capacity occupancy (an overflow silently drops work)."""
    out = {}
    st = buffers.stats
    if st is not None:
        out["cap_cov"] = st["n_cov"] / st["cov_capacity"]
        out["cap_aa"] = (torch.maximum(st["aa_pairs_x"], st["aa_pairs_y"])
                         / st["aa_capacity"])
        if st.get("aa_dense"):
            out["aa_dense"] = torch.tensor(st["aa_dense"])
    if buffers.rast.n_max_tile is not None:
        out["n_max_tile"] = buffers.rast.n_max_tile
        out["n_big_faces"] = buffers.rast.n_big
    if meshes is not None:
        out["n_cross"] = meshes.mesh.n_cross
        out["n_valid_tets"] = meshes.mesh.n_valid_tets
    return out


def _eikonal_term(generator, model, params, meshes, buffers, it, cfg, draws):
    """Eikonal loss on points sampled from the posed surface; the face
    areas reuse the render's corner gather where it kept one."""
    if not cfg.loss.use_eikonal:
        return torch.zeros((), device=meshes.verts_posed.device)
    mesh = meshes.mesh
    pts = mesh_ops.sample_points_on_mesh(
        meshes.verts_posed, mesh.faces, cfg.geometry.n_eikonal_samples,
        mesh.face_valid, fn_raw=(buffers.stats or {}).get("fn_raw"),
        generator=generator, draws=(draws or {}).get("eik"))
    return eikonal_loss(model, params, pts, it, cfg)


def _annealed_sdf_reg(meshes, model, it, epoch, cfg):
    reg = cfg.loss.sdf_regularizer
    sdf_w = reg - (reg - 0.01) * min(1.0, 4.0 * (it / epoch))
    return sdf_reg_loss(meshes.sdf, model.grid) * sdf_w


def tick_init(generator: Optional[torch.Generator], model: GeometryModel,
              params, pose_params, tex_module, tex_params,
              perceptual: ConvPerceptual, perc_params, target: dict,
              it: int, cfg: Config, raster_opts: Optional[dict] = None,
              draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Loss dict of one init iteration. With ``cfg.render.init_shading``
    the render also samples the texture and ``img_loss`` gains its image
    term (log-only either way)."""
    if not 0 < cfg.render.max_covered_frac < 1:
        raise NotImplementedError("the init tick renders the compacted "
                                  "path only (0 < max_covered_frac < 1)")
    shade = bool(cfg.render.init_shading)
    # the init total is reg + normal + msk: the smoothness regularizers
    # never enter it, so the render drops their channels
    meshes, buffers = render_stage_mesh(
        generator, model, params, pose_params, tex_module, tex_params,
        target, cfg, raster_opts=raster_opts, shade=shade,
        need_smoothness=False, draws=(draws or {}).get("render"))

    color_ref = target["all_img"]
    gt_mask = color_ref[..., 3:]
    msk_loss = 100.0 * ((buffers.shaded[..., 3:] - gt_mask) ** 2).mean()
    # log-only (not in the total, ref train.py:718)
    img_loss = msdf_image_hinges(buffers, gt_mask)
    if shade:
        img_loss = make_loss_fn(cfg.loss.loss)(
            buffers.shaded[..., 0:3] * gt_mask,
            color_ref[..., 0:3] * gt_mask) + img_loss

    eik = _eikonal_term(generator, model, params, meshes, buffers, it, cfg,
                        draws)
    sdf_reg = _annealed_sdf_reg(meshes, model, it, cfg.stages.init_epoch, cfg)

    out_n, ref_n = _normal_images(buffers, target["all_normal"])
    normal_loss = 50.0 * perceptual.loss(perc_params, out_n[None],
                                         ref_n[None])
    reg_loss = sdf_reg + eik
    total = reg_loss + normal_loss + msk_loss
    out = {
        "total": total, "img_loss": img_loss, "msk_loss": msk_loss,
        "sdf_reg_loss": sdf_reg, "eik_loss": eik, "reg_loss": reg_loss,
        "normal_loss": normal_loss,
        "iou": mask_iou(buffers.shaded[..., 3:], gt_mask),
    }
    out.update(capacity_metrics(buffers, meshes))
    return out


def mesh_msdf_reg_loss(meshes, buffers: MeshBuffers, cfg: Config
                       ) -> torch.Tensor:
    """Mesh-mSDF open/close regularizers (ref hmsdf.py:996-1028).
    ``mesh.msdf_aug`` is ALREADY the sign-corrected view (level 2 of the
    extraction multiplies by the half's sign before storing), so the sign
    is not applied again here: the two halves' values differ."""
    mesh = meshes.mesh
    msdf_aug = mesh.msdf_aug
    out = torch.zeros((), device=msdf_aug.device)
    regscale = (64.0 / cfg.geometry.grid_res) ** 3
    eps = 1e-3
    open_s = cfg.loss.msdf_reg_open_scale
    close_s = cfg.loss.msdf_reg_close_scale
    if open_s > 0:
        out = open_s * regscale * _huber_sum(msdf_aug.clamp_min(-eps), -eps)
    if close_s != 0:
        # visible boundary verts: faces the rasterizer saw -> the vertices
        # of their boundary blocks, counted through the scatter kernel
        MV = mesh.n_verts_watertight
        nv = mesh.verts.shape[0]
        seen = (buffers.visible_faces & mesh.face_valid)[:, None]
        ids = torch.where(seen, mesh.faces, nv).reshape(-1)
        cnt = coo_scatter_add(
            ids, torch.ones((ids.shape[0], 1), device=ids.device), nv + 1)
        bnd_seen = cnt[MV:-1, 0] > 0
        out = out + close_s * regscale * _huber_sum(
            msdf_aug[MV:].clamp_max(eps), eps, mask=bnd_seen)
    return out


def tick_split_one(generator: Optional[torch.Generator],
                   model: GeometryModel, params, pose_params, tex_module,
                   tex_params, perceptual: ConvPerceptual, perc_params,
                   target: dict, it: int, cfg: Config, mesh_type: str,
                   raster_opts: Optional[dict] = None, meshes=None,
                   draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """One half (cloth or body) of the split tick."""
    sign = 1.0 if mesh_type == "cloth" else -1.0
    draws = draws or {}
    meshes, buffers = render_stage_mesh(
        generator, model, params, pose_params, tex_module, tex_params,
        target, cfg, msdf_sign=sign, raster_opts=raster_opts, meshes=meshes,
        draws=draws.get("render"))

    color_ref = target[f"{mesh_type}_img"]
    normal_ref = target[f"{mesh_type}_normal"]
    gt_mask = color_ref[..., 3:]
    msk_loss = ((buffers.shaded[..., 3:] - gt_mask) ** 2).mean()
    img_loss = make_loss_fn(cfg.loss.loss)(
        buffers.shaded[..., 0:3] * gt_mask, color_ref[..., 0:3] * gt_mask)
    img_loss = img_loss + msdf_image_hinges(buffers, gt_mask)

    eik = _eikonal_term(generator, model, params, meshes, buffers, it, cfg,
                        draws)
    mesh_msdf_reg = (mesh_msdf_reg_loss(meshes, buffers, cfg)
                     if cfg.loss.use_mesh_msdf_reg
                     else torch.zeros((), device=gt_mask.device))
    sdf_reg = _annealed_sdf_reg(meshes, model, it, cfg.stages.split_epoch,
                                cfg)

    lc = cfg.loss
    if buffers.stats is not None:
        mtl_smooth = regularizer.material_smoothness_compact(
            buffers.stats, lc.lambda_kd, lc.lambda_ks, lc.lambda_nrm)
    else:
        mtl_smooth = regularizer.material_smoothness_grad(
            buffers.kd_grad, buffers.ks_grad, buffers.normal_grad,
            lc.lambda_kd, lc.lambda_ks, lc.lambda_nrm)
    chroma = regularizer.chroma_loss(buffers.kd, color_ref, lc.lambda_chroma)

    out_n, ref_n = _normal_images(buffers, normal_ref)
    on, rn = out_n * 2 - 1, ref_n * 2 - 1
    normal_mse = ((on - rn) ** 2).mean()
    norms = torch.linalg.norm(on, dim=-1) * torch.linalg.norm(rn, dim=-1)
    normal_cos = 0.1 * (1.0 - ((on * rn).sum(-1)
                               / norms.clamp_min(1e-8)).mean())
    crop_a, crop_b = random_crop_pair(generator, out_n[None], ref_n[None],
                                      lc.perceptual_crop,
                                      offsets=draws.get("crop"))
    normal_loss = 5.0 * perceptual.loss(perc_params, crop_a, crop_b)

    # mesh_msdf_reg is LOG-ONLY: the reference's reg_loss is geometry +
    # shading regularizers and its training loop's total never adds it
    reg_loss = (sdf_reg + eik) + (mtl_smooth + chroma)
    out = {
        "img_loss": img_loss, "msk_loss": msk_loss, "eik_loss": eik,
        "sdf_reg_loss": sdf_reg, "mesh_msdf_reg_loss": mesh_msdf_reg,
        "mtl_smooth_loss": mtl_smooth, "chroma_loss": chroma,
        "reg_loss": reg_loss, "normal_loss": normal_loss,
        "normal_loss_mse": normal_mse, "normal_loss_cos": normal_cos,
    }
    out.update(capacity_metrics(buffers, meshes))
    return out


def tick_split(generator: Optional[torch.Generator], model: GeometryModel,
               params, pose_params, tex_module, tex_params,
               perceptual: ConvPerceptual, perc_params, target: dict,
               it: int, cfg: Config, raster_opts: Optional[dict] = None,
               draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Both halves over one shared extraction + LBS, with the training
    loop's weights: img + normal + reg of each half + 10x each mask loss."""
    meshes = dict(zip(("cloth", "body"), model.get_meshes_pair(
        params, pose_params, int(target["frame_idx"]))))
    halves = {
        name: tick_split_one(
            generator, model, params, pose_params, tex_module, tex_params,
            perceptual, perc_params, target, it, cfg, name, raster_opts,
            meshes=meshes[name], draws=(draws or {}).get(name))
        for name in ("cloth", "body")}
    cloth, body = halves["cloth"], halves["body"]
    total = (cloth["img_loss"] + cloth["normal_loss"] + cloth["reg_loss"]
             + body["img_loss"] + body["normal_loss"] + body["reg_loss"]
             + 10.0 * cloth["msk_loss"] + 10.0 * body["msk_loss"])
    out = {"total": total}
    for name, half in halves.items():
        out.update({f"{name}_{k}": v for k, v in half.items()})
    return out


def tick_seq(generator: Optional[torch.Generator], model: GeometryModel,
             params, pose_params, tex_module, tex_params,
             perceptual: ConvPerceptual, perc_params, template: SeqTemplate,
             target: dict, it: int, cfg: Config,
             raster_opts: Optional[dict] = None,
             draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """One seq iteration with the driver's weights (ref train.py:1412-1421):
    250 x normal + 0.1 x shading regularizers + the three mask losses
    + 1e6 x Laplacian + 1e5 x collision + 1e3 x normal consistency + the
    offsets' squared sum. The image losses are log-only."""
    posed, delta = model.seq_deformed(params, template, pose_params,
                                      int(target["frame_idx"]))
    r, lc = cfg.render, cfg.loss
    buffers = render_mesh(
        generator, posed, template.v, template.f,
        torch.ones((template.f.shape[0],), dtype=torch.bool,
                   device=posed.device),
        target["mvp"], target["campos"], tuple(r.train_res), tex_module,
        tex_params, target["background"], face_labels=template.face_labels,
        spp=r.spp, raster_opts=raster_opts,
        max_covered_frac=r.max_covered_frac,
        jitter_subsample=r.jitter_subsample, aa_dense=r.aa_dense,
        draws=(draws or {}).get("render"))

    # mask decomposition by the per-pixel face label (ref hmsdf.py:788-798)
    alpha = buffers.alpha
    cloth_mask = buffers.mesh_id * alpha
    body_mask = (1.0 - buffers.mesh_id) * alpha
    gt_all, gt_cloth, gt_body = (target["all_img"], target["cloth_img"],
                                 target["body_img"])
    loss_fn = make_loss_fn(lc.loss)
    rgb = buffers.shaded[..., 0:3]
    all_msk = 200.0 * ((alpha - gt_all[..., 3:]) ** 2).mean()
    cloth_msk = 200.0 * ((cloth_mask - gt_cloth[..., 3:]) ** 2).mean()
    body_msk = 200.0 * ((body_mask - gt_body[..., 3:]) ** 2).mean()
    all_img = loss_fn(rgb * alpha, gt_all[..., 0:3])
    cloth_img = loss_fn(rgb * cloth_mask, gt_cloth[..., 0:3])
    body_img = loss_fn(rgb * body_mask, gt_body[..., 0:3])

    if buffers.stats is not None:
        mtl_smooth = regularizer.material_smoothness_compact(
            buffers.stats, lc.lambda_kd, lc.lambda_ks, lc.lambda_nrm)
    else:
        mtl_smooth = regularizer.material_smoothness_grad(
            buffers.kd_grad, buffers.ks_grad, buffers.normal_grad,
            lc.lambda_kd, lc.lambda_ks, lc.lambda_nrm)
    chroma = regularizer.chroma_loss(buffers.kd, gt_all, lc.lambda_chroma)
    shading_reg = mtl_smooth + chroma
    delta_loss = (delta * delta).sum()

    out_n, ref_n = _normal_images(buffers, target["all_normal"])
    normal_loss = 20.0 * perceptual.loss(perc_params, out_n[None],
                                         ref_n[None])

    with span("d3h.seq.mesh_reg"):
        lap = mesh_ops.laplacian_uniform_loss(posed, template.f)
        nds_normal = mesh_ops.normal_consistency_loss(
            posed, template.f, template.connected_faces)
    colli = collision_loss(gather_rows(posed, template.cloth_vidx),
                           gather_rows(posed, template.body_vidx),
                           template.body_f, lc.collision_push_eps)

    total = (250.0 * normal_loss + 0.1 * shading_reg
             + body_msk + cloth_msk + all_msk
             + 1e6 * lap + 1e5 * colli + 1e3 * nds_normal + delta_loss)
    out = {
        "total": total, "all_img_loss": all_img, "all_msk_loss": all_msk,
        "cloth_img_loss": cloth_img, "cloth_msk_loss": cloth_msk,
        "body_img_loss": body_img, "body_msk_loss": body_msk,
        "laplacian_loss": lap, "colli_loss": colli,
        "nds_normal_loss": nds_normal, "normal_loss": normal_loss,
        "delta_loss": delta_loss, "mtl_smooth_loss": mtl_smooth,
        "chroma_loss": chroma, "reg_loss": shading_reg,
    }
    out.update(capacity_metrics(buffers))
    return out
