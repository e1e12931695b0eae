"""Bilateral denoiser (counterpart of ``d3human_tpu/ops/denoiser.py``): a
cross-bilateral blur of the shaded buffer guided by normal and depth
similarity over a fixed window, as a sum of shifted copies of the
edge-padded images (differentiable in every input), with the sigma
ramped by training progress (``BilateralDenoiser.set_influence``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _edge_pad(img: torch.Tensor, half: int) -> torch.Tensor:
    """[H, W, C] padded by ``half`` on each side with the edge values."""
    x = img.permute(2, 0, 1)[None]
    return F.pad(x, (half, half, half, half), mode="replicate")[0] \
        .permute(1, 2, 0)


def bilateral_denoise(color: torch.Tensor,      # [H, W, 3]
                      normal: torch.Tensor,     # [H, W, 3]
                      depth: torch.Tensor,      # [H, W, 1+] (z first)
                      sigma: float = 2.0, window: int = 7,
                      sigma_n: float = 0.25,
                      sigma_z: float = 0.1) -> torch.Tensor:
    half = window // 2
    H, W = color.shape[:2]
    z = depth[..., :1]
    cp, np_, zp = (_edge_pad(a, half) for a in (color, normal, z))
    acc = torch.zeros_like(color)
    wacc = torch.zeros((H, W, 1), dtype=color.dtype, device=color.device)
    for dy in range(window):
        for dx in range(window):
            w_s = math.exp(-((dy - half) ** 2 + (dx - half) ** 2)
                           / (2.0 * sigma ** 2))
            c = cp[dy:dy + H, dx:dx + W]
            n = np_[dy:dy + H, dx:dx + W]
            zs = zp[dy:dy + H, dx:dx + W]
            w_n = torch.exp(-((n - normal) ** 2).sum(-1, keepdim=True)
                            / (2.0 * sigma_n ** 2))
            w_z = torch.exp(-((zs - z) ** 2) / (2.0 * sigma_z ** 2))
            w = w_s * w_n * w_z
            acc = acc + c * w
            wacc = wacc + w
    return acc / wacc.clamp_min(1e-8)


class BilateralDenoiser:
    """``bilateral_denoise`` with sigma = sigma_max * influence (at least
    1e-3); the influence ramps with training progress."""

    def __init__(self, influence: float = 1.0, sigma_max: float = 2.0):
        self.sigma_max = sigma_max
        self.influence = influence

    def set_influence(self, factor: float) -> None:
        self.influence = factor

    def __call__(self, color, normal, depth):
        sigma = max(self.sigma_max * self.influence, 1e-3)
        return bilateral_denoise(color, normal, depth, sigma=sigma)
