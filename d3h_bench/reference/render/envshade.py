"""Monte-Carlo environment lighting, the ``bsdf="pbr"`` shading
(counterpart of ``d3human_tpu/render/envshade.py``).

Directions are importance-sampled from the probe's row / column CDFs
(``light.update_pdf``) by inverse-CDF search; each pixel takes a Lambert
diffuse and a single-scatter GGX specular term per sample (light sampling
only); occlusion, when an ``sdf_fn`` is given, comes from sphere-tracing
that field (positive inside) from the surface toward the light.

Random draws: ``sample_light_dirs`` takes its two uniform vectors
(``uy``, ``ux`` [n]) from ``draws`` when given (the tests pass the JAX
package's), else from ``generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from d3h_bench.reference.render import light as light_mod


def _dir_from_latlong(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(u, v) in [0, 1]^2 -> direction (y-up lat-long, as
    ``light.sample_latlong`` reads it)."""
    phi = (u - 0.5) * (2.0 * math.pi)
    theta = v * math.pi
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack([st * torch.sin(phi), ct, -st * torch.cos(phi)], -1)


def sample_light_dirs(generator: Optional[torch.Generator], light_params,
                      pdf_tables, n: int, draws=None):
    """Importance-sample ``n`` directions from the probe CDFs.
    ``draws = (uy, ux)`` [n] injects the uniforms. Returns (dirs [n, 3],
    radiance [n, 3], pdf over solid angle [n])."""
    rows, cols, pdf = (pdf_tables[k] for k in ("rows", "cols", "pdf"))
    H, W = pdf.shape
    dev = pdf.device
    if draws is None:
        uy = torch.rand((n,), generator=generator, device=dev)
        ux = torch.rand((n,), generator=generator, device=dev)
    else:
        uy, ux = (d.to(dev, torch.float32) for d in draws)
    # left-sided searches, as jnp.searchsorted; the row CDF is constant
    # across columns, so column 0 serves
    ri = torch.searchsorted(rows[:, 0].contiguous(), uy).clamp(0, H - 1)
    ci = torch.searchsorted(cols[ri], ux[:, None])[:, 0].clamp(0, W - 1)
    u = (ci.float() + 0.5) / W
    v = (ri.float() + 0.5) / H
    dirs = _dir_from_latlong(u, v)
    radiance = light_mod.sample_latlong(light_params, dirs)
    # p(texel) * H W / (2 pi^2 sin(theta))
    sin_t = torch.sin(v * math.pi).clamp_min(1e-4)
    p = pdf[ri, ci] * (H * W) / (2.0 * math.pi * math.pi * sin_t)
    return dirs, radiance, p.clamp_min(1e-8)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1, keepdim=True)


def ggx_specular(n, v, l, rough, f0: float = 0.04):
    """Single-scatter GGX with Schlick's Fresnel and Smith's G."""
    h = n * 0.0 + (v + l)
    h = h / h.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    nl = _dot(n, l).clamp(0.0, 1.0)
    nv = _dot(n, v).clamp(1e-4, 1.0)
    nh = _dot(n, h).clamp(0.0, 1.0)
    vh = _dot(v, h).clamp(0.0, 1.0)
    a = rough.clamp_min(0.03) ** 2
    a2 = a * a
    d = a2 / (math.pi * ((nh * nh * (a2 - 1) + 1) ** 2)).clamp_min(1e-8)
    k = a / 2.0
    g = ((nl / (nl * (1 - k) + k).clamp_min(1e-8))
         * (nv / (nv * (1 - k) + k).clamp_min(1e-8)))
    f = f0 + (1 - f0) * (1 - vh) ** 5
    return d * g * f / (4.0 * nv).clamp_min(1e-8)


def sphere_trace_shadow(sdf_fn: Callable, origin: torch.Tensor,
                        direction: torch.Tensor, n_steps: int = 16,
                        t0: float = 0.02,
                        softness: float = 16.0) -> torch.Tensor:
    """Soft shadow by sphere-tracing ``sdf_fn`` (points [..., 3] -> [...],
    positive inside) for ``n_steps`` steps: visibility in [0, 1]."""
    t = torch.full(origin.shape[:-1], t0, device=origin.device)
    vis = torch.ones(origin.shape[:-1], device=origin.device)
    for _ in range(n_steps):
        d = -sdf_fn(origin + direction * t[..., None])
        vis = torch.minimum(vis, (softness * d / t.clamp_min(1e-3))
                            .clamp(0.0, 1.0))
        t = t + d.clamp(0.01, 0.15)
    return vis


def env_shade(generator: Optional[torch.Generator],
              gb_pos: torch.Tensor,        # [..., 3]
              gb_normal: torch.Tensor,     # [..., 3]
              view_pos: torch.Tensor,      # [3]
              kd: torch.Tensor,            # [..., 3]
              ks: torch.Tensor,            # [..., 3] (o, roughness, metal)
              light_params, n_samples: int = 8,
              sdf_fn: Optional[Callable] = None, shadow_scale: float = 1.0,
              draws=None):
    """(diffuse, specular) light, each [..., 3], demodulated: the caller
    multiplies the diffuse by the albedo."""
    pdf_tables = light_mod.update_pdf(light_params)
    dirs, radiance, p = sample_light_dirs(generator, light_params,
                                          pdf_tables, n_samples, draws)
    v = view_pos - gb_pos
    v = v / v.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    diffuse = torch.zeros_like(kd)
    specular = torch.zeros_like(kd)
    rough = ks[..., 1:2]
    for s in range(n_samples):
        l = dirs[s].expand(gb_pos.shape)
        li = radiance[s] / p[s]
        nl = _dot(gb_normal, l).clamp(0, 1)
        vis = 1.0
        if sdf_fn is not None:
            vis_s = sphere_trace_shadow(sdf_fn, gb_pos + gb_normal * 1e-3, l)
            vis = 1.0 - shadow_scale * (1.0 - vis_s[..., None])
        diffuse = diffuse + li * nl * vis / math.pi
        specular = specular + li * ggx_specular(gb_normal, v, l, rough) \
            * nl * vis
    return diffuse / n_samples, specular / n_samples
