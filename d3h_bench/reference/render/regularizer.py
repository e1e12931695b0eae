"""Image- and material-space regularizers (counterpart of
``d3human_tpu/render/regularizer.py``). The smoothness inputs are the
shader's jittered texture and normal taps (``render/pipeline.py``);
``shading_loss`` takes the environment-light render's diffuse and specular
light buffers (``render_mesh(bsdf="pbr")``)."""

from __future__ import annotations

import torch

from d3h_bench.reference.ops.image_loss import _tonemap_log_srgb


def _luma(x: torch.Tensor) -> torch.Tensor:
    return (x[..., 0:1] + x[..., 1:2] + x[..., 2:3]) / 3


def _value(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0:3].max(dim=-1, keepdim=True).values


def chroma_loss(kd: torch.Tensor, color_ref: torch.Tensor,
                lambda_chroma: float) -> torch.Tensor:
    eps = 0.001
    ref_chroma = color_ref[..., 0:3] / _value(color_ref).clamp_min(eps)
    opt_chroma = kd[..., 0:3] / _value(kd).clamp_min(eps)
    return (((opt_chroma - ref_chroma) * color_ref[..., 3:]).abs().mean()
            * lambda_chroma)


def shading_loss(diffuse_light, specular_light, color_ref,
                 lambda_diffuse: float, lambda_specular: float
                 ) -> torch.Tensor:
    """The lights' luma against the reference's value in log-sRGB over its
    mask, plus the specular-to-diffuse ratio (ref render/regularizer.py:
    29)."""
    eps = 0.001
    dl = _luma(diffuse_light)
    sl = _luma(specular_light)
    ref = _value(color_ref)
    mask = color_ref[..., 3:]
    img = _tonemap_log_srgb((dl + sl) * mask)
    tgt = _tonemap_log_srgb(ref * mask)
    loss = (img - tgt).abs().mean() * lambda_diffuse
    return loss + sl.mean() / dl.mean().clamp_min(eps) * lambda_specular


def material_smoothness_grad(kd_grad, ks_grad, nrm_grad, lambda_kd=0.25,
                             lambda_ks=0.1, lambda_nrm=0.0) -> torch.Tensor:
    """Means over the full-image smoothness buffers ([..., :-1] value,
    [..., -1] weight)."""
    kd_luma = (kd_grad[..., 0] + kd_grad[..., 1] + kd_grad[..., 2]) / 3
    loss = (kd_luma * kd_grad[..., -1]).mean() * lambda_kd
    loss = loss + (ks_grad[..., :-1] * ks_grad[..., -1:]).mean() * lambda_ks
    loss = loss + (nrm_grad[..., :-1] * nrm_grad[..., -1:]).mean() * lambda_nrm
    return loss


def material_smoothness_compact(stats: dict, lambda_kd=0.25, lambda_ks=0.1,
                                lambda_nrm=0.0) -> torch.Tensor:
    """``material_smoothness_grad`` on the compacted-pixel stats of
    ``render_mesh_compact``: the full-image means reduce to
    sum-over-covered / npix, the 1/jitter_subsample subsample rescaled to
    the same expectation."""
    npix = stats["npix"]
    ss = stats["jitter_subsample"]
    kd_luma = stats["kd_grad"].sum(-1) / 3.0
    loss = kd_luma.sum() * ss / npix * lambda_kd
    loss = loss + stats["ks_grad"].sum() * ss / (npix * 3) * lambda_ks
    loss = loss + stats["nrm_grad"].sum() * ss / (npix * 3) * lambda_nrm
    return loss
