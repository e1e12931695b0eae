"""HDR image losses with tonemapping, sRGB conversions, PSNR and SSIM
(counterpart of ``d3human_tpu/ops/image_loss.py``): losses
{l1, mse, smape, relmse} x tonemappers {none, log_srgb}."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def srgb_to_rgb(f: torch.Tensor) -> torch.Tensor:
    return torch.where(
        f <= 0.04045, f / 12.92,
        torch.pow((f.clamp_min(0.04045) + 0.055) / 1.055, 2.4))


def rgb_to_srgb(f: torch.Tensor) -> torch.Tensor:
    return torch.where(
        f > 0.0031308,
        torch.pow(f.clamp_min(0.0031308), 1.0 / 2.4) * 1.055 - 0.055,
        12.92 * f)


def _tonemap_log_srgb(f: torch.Tensor) -> torch.Tensor:
    return rgb_to_srgb(torch.log(f.clamp(0.0, 65535.0) + 1.0))


def image_loss(img: torch.Tensor, ref: torch.Tensor, loss: str = "l1",
               tonemapper: str = "none") -> torch.Tensor:
    if tonemapper == "log_srgb":
        img = _tonemap_log_srgb(img)
        ref = _tonemap_log_srgb(ref)
    if loss == "mse":
        return ((img - ref) ** 2).mean()
    if loss == "smape":
        return ((img - ref).abs() / (img.abs() + ref.abs() + 0.01)).mean()
    if loss == "relmse":
        return ((img - ref) ** 2 / (img * img + ref * ref + 0.1)).mean()
    return (img - ref).abs().mean()


_LOSSES = {
    "smape": ("smape", "none"),
    "mse": ("mse", "none"),
    "logl1": ("l1", "log_srgb"),
    "logl2": ("mse", "log_srgb"),
    "relmse": ("relmse", "none"),
}


def make_loss_fn(name: str):
    loss, tm = _LOSSES[name]
    return lambda img, ref: image_loss(img, ref, loss=loss, tonemapper=tm)


def mse_to_psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(mse.clamp_min(1e-10))


def ssim(img0: torch.Tensor, img1: torch.Tensor, window: int = 11,
         sigma: float = 1.5, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2) -> torch.Tensor:
    """Gaussian-window SSIM over [H, W, C] or [N, H, W, C] images: a
    separable zero-padded blur along H then W, per channel."""
    half = window // 2
    x = torch.arange(window, dtype=torch.float32, device=img0.device) - half
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()

    def blur(im):
        lead = im.shape[:-3]
        H, W, C = im.shape[-3:]
        t = im.reshape(-1, H, W, C).permute(0, 3, 1, 2).reshape(-1, 1, H, W)
        t = F.conv2d(t, g.reshape(1, 1, window, 1), padding=(half, 0))
        t = F.conv2d(t, g.reshape(1, 1, 1, window), padding=(0, half))
        return t.reshape(-1, C, H, W).permute(0, 2, 3, 1).reshape(
            *lead, H, W, C)

    mu0, mu1 = blur(img0), blur(img1)
    s00 = blur(img0 * img0) - mu0 * mu0
    s11 = blur(img1 * img1) - mu1 * mu1
    s01 = blur(img0 * img1) - mu0 * mu1
    num = (2 * mu0 * mu1 + c1) * (2 * s01 + c2)
    den = (mu0 ** 2 + mu1 ** 2 + c1) * (s00 + s11 + c2)
    return (num / den).mean()
