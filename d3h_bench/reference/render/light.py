"""Trainable lat-long environment light (counterpart of
``d3human_tpu/render/light.py``): the [H, W, 3] probe parameter, its
post-step clamp, the importance-sampling tables (``update_pdf``), the
bilinear probe lookup by direction (``sample_latlong``) and the resampled
probe image (``generate_image``). Albedo-only shading never reads the
probe; the environment-light render (``render/envshade.py``) does."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from d3h_bench.reference.ops.scan import inclusive_scan
from d3h_bench.reference.ops.scatter import gather_rows

Params = dict


def create_trainable_env(gen: torch.Generator, base_res: int = 256,
                         scale: float = 0.0, bias: float = 0.5,
                         device="cuda") -> Params:
    base = torch.rand((base_res, base_res, 3), generator=gen, device=gen.device) * scale + bias
    return {"base": base.to(device)}


def clamp_(params: Params, min_val: float = 1e-4) -> None:
    """Post-step clamp, in place (a light of 0 kills its gradient)."""
    with torch.no_grad():
        params["base"].clamp_(min=min_val)


def update_pdf(params: Params) -> Dict[str, torch.Tensor]:
    """Luminance PDF and row / column CDFs of the probe, weighted by
    sin(theta); the probe is detached (JAX ``stop_gradient``).
    Returns {pdf [H, W], rows [H, W], cols [H, W]}."""
    base = params["base"].detach()
    H, W = base.shape[:2]
    y = (torch.arange(H, dtype=torch.float32, device=base.device) + 0.5) / H
    pdf = base.amax(-1) * torch.sin(y * math.pi)[:, None]
    pdf = pdf / pdf.sum().clamp_min(1e-12)
    # fixed-order scans (every column of rows is the same scan)
    cols = inclusive_scan(pdf)
    rows = inclusive_scan(cols[:, -1])[:, None].expand(H, W)
    one = torch.ones((), device=base.device)
    cols = cols / torch.where(cols[:, -1:] > 0, cols[:, -1:], one)
    rows = rows / torch.where(rows[-1:, :] > 0, rows[-1:, :], one)
    return {"pdf": pdf, "rows": rows, "cols": cols}


def sample_latlong(params: Params, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear probe lookup for world directions [..., 3] (y-up lat-long):
    wraps in u, clamps in v; differentiable in ``base``."""
    base = params["base"]
    H, W = base.shape[:2]
    d = dirs / dirs.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    u = (torch.atan2(d[..., 0], -d[..., 2]) / (2 * math.pi) + 0.5) * W - 0.5
    v = torch.arccos(d[..., 1].clamp(-1, 1)) / math.pi * H - 0.5
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    # float -> int32 truncates toward zero as XLA's convert does; the
    # floor-mod then wraps negative u as jnp.mod does
    u0 = torch.remainder(u0.to(torch.int32), W).long()
    u1 = torch.remainder(u0 + 1, W)
    v0 = v0.to(torch.int32).clamp(0, H - 1).long()
    v1 = (v0 + 1).clamp(0, H - 1)
    # the four taps by one row gather, whose backward is the scatter
    taps = gather_rows(base.reshape(H * W, -1),
                       torch.stack([v0 * W + u0, v0 * W + u1, v1 * W + u0,
                                    v1 * W + u1], -1))
    return (taps[..., 0, :] * ((1 - fu) * (1 - fv))
            + taps[..., 1, :] * (fu * (1 - fv))
            + taps[..., 2, :] * ((1 - fu) * fv)
            + taps[..., 3, :] * (fu * fv))


def generate_image(params: Params, res: Tuple[int, int]) -> torch.Tensor:
    """The probe resampled to ``res`` = (h, w), bilinear with clamped
    borders (for checkpoints and pictures)."""
    base = params["base"]
    H, W = base.shape[:2]
    h, w = res
    dev = base.device
    yy = (torch.arange(h, device=dev) + 0.5) / h * H - 0.5
    xx = (torch.arange(w, device=dev) + 0.5) / w * W - 0.5
    y0 = torch.floor(yy).to(torch.int32).clamp(0, H - 1).long()
    x0 = torch.floor(xx).to(torch.int32).clamp(0, W - 1).long()
    y1 = (y0 + 1).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    fy = (yy - y0)[:, None, None]
    fx = (xx - x0)[None, :, None]
    return (base[y0][:, x0] * (1 - fy) * (1 - fx)
            + base[y0][:, x1] * (1 - fy) * fx
            + base[y1][:, x0] * fy * (1 - fx)
            + base[y1][:, x1] * fy * fx)
