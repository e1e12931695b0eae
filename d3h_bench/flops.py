"""The floating-point operations a training step needs, counted from the
configuration's fixed sizes: the work that no implementation of the step
can leave out. Data-dependent work (the covered pixels, the collision
search's pairs, the extraction) is not counted, so the count is a floor
and a step's share of the peak never reads above its true share.

Counted (a multiply-add is two operations):
- the SDF MLP over the grid's vertices: forward, and the backward's input
  and weight gradients (3 passes; 2 in split, whose SDF MLP is frozen);
- the eikonal term's samples: forward, the input gradient, and in init
  the weight gradients of both (4 passes, a floor of the double
  backward; 2 in split, once a half);
- the seq stage's DeformMLP over the template's vertices (3 passes);
- the perceptual loss's convolutions on the two images it compares:
  forward of both, and the input gradient of the rendered one (3);
- a fit cell's step (``pretrain_sdf``): the SDF MLP over the grid's
  vertices, forward, weight gradients and the hidden layers' input
  gradients."""

from __future__ import annotations

from typing import Sequence

# f32 operations a second of one H100 SXM outside the tensor cores (the
# data sheet's dense rate, at the 700 W limit): the port computes in f32
# with TF32 off
PEAK_F32 = 67e12


def posenc_dim(n_freq: int) -> int:
    return 3 * (2 * n_freq + 1)


def mlp_flops(n_freq: int, d_hidden: int, n_hidden: int,
              skip_in: Sequence[int], d_out: int, d_extra: int = 0) -> int:
    """Operations of one point's forward pass through the fields' MLP."""
    d_emb = posenc_dim(n_freq)
    n = (d_emb + d_extra) * d_hidden
    for i in range(n_hidden):
        n += (d_hidden + (d_emb if i in skip_in else 0)) * d_hidden
    n += d_hidden * d_out
    return 2 * n


def conv_flops(h: int, w: int, channels: Sequence[int]) -> int:
    """Operations of the perceptual backbone's 3x3 stride-2 convolutions
    on one [h, w, 3] image."""
    n, c_in = 0, 3
    for c in channels:
        h, w = -(-h // 2), -(-w // 2)
        n += 2 * h * w * c * c_in * 9
        c_in = c
    return n


def step_flops(cfg, stage: str, n_grid_verts: int,
               n_template_verts: int = 0,
               perceptual_channels: Sequence[int] = (24, 48, 96)) -> float:
    """Operations of one training step of ``stage`` under ``cfg`` (the
    port's or the reference's Config)."""
    f = cfg.field
    H, W = cfg.render.train_res
    sdf = mlp_flops(f.n_freq, f.d_hidden, f.n_hidden, f.skip_in, 1)
    eik = cfg.geometry.n_eikonal_samples if cfg.loss.use_eikonal else 0
    if stage == "init":
        return (3 * n_grid_verts * sdf + 4 * eik * sdf
                + 3 * conv_flops(H, W, perceptual_channels))
    if stage == "split":
        c = min(cfg.loss.perceptual_crop, H, W)
        return (2 * n_grid_verts * sdf + 2 * 2 * eik * sdf
                + 2 * 3 * conv_flops(c, c, perceptual_channels))
    if stage == "seq":
        deform = mlp_flops(f.n_freq_deform, f.d_hidden, f.n_hidden,
                           f.skip_in, 3, d_extra=f.pose_code_dim)
        return (3 * n_template_verts * deform
                + 3 * conv_flops(H, W, perceptual_channels))
    if stage == "pretrain_sdf":
        # the grid's vertices need no gradient: the encoding's share of
        # the input and skip layers has no input gradient
        d_emb = posenc_dim(f.n_freq)
        no_input_grad = 2 * d_emb * f.d_hidden * (1 + len(f.skip_in))
        return n_grid_verts * (3 * sdf - no_input_grad)
    raise ValueError(f"stage {stage!r}")
