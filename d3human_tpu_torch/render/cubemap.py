"""Cubemaps and their diffuse / GGX-specular prefiltering (counterpart of
``d3human_tpu/render/cubemap.py``): texel directions and solid angles,
lat-long <-> cubemap conversion, and the prefilters as one dense
[Nd, Ns] weight product over all source texels each (meant for probe
resolutions up to 64 a face).

Faces are ordered +x, -x, +y, -y, +z, -z; lat-long rows run from the
top pole down. The direction tables are built on the host in float64 and
cast, as in the JAX package."""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch


def cube_dirs(res: int, device="cuda") -> torch.Tensor:
    """[6, res, res, 3] unit direction of each texel centre."""
    u = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    v, uu = np.meshgrid(u, u, indexing="ij")
    one = np.ones_like(uu)
    faces = [
        np.stack([one, -v, -uu], -1),     # +x
        np.stack([-one, -v, uu], -1),     # -x
        np.stack([uu, one, v], -1),       # +y
        np.stack([uu, -one, -v], -1),     # -y
        np.stack([uu, -v, one], -1),      # +z
        np.stack([-uu, -v, -one], -1),    # -z
    ]
    d = np.stack(faces, 0)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(d.astype(np.float32)).to(device)


def texel_solid_angles(res: int, device="cuda") -> torch.Tensor:
    """[6, res, res] solid angle of each texel (the exact integral)."""
    g = (np.arange(res + 1) / res) * 2.0 - 1.0
    xa, ya = np.meshgrid(g, g, indexing="ij")
    A = np.arctan2(xa * ya, np.sqrt(xa * xa + ya * ya + 1.0))
    sa = A[1:, 1:] - A[:-1, 1:] - A[1:, :-1] + A[:-1, :-1]
    return torch.as_tensor(np.broadcast_to(sa[None], (6, res, res))
                           .astype(np.float32)).to(device)


def latlong_to_cubemap(latlong: torch.Tensor, res: int) -> torch.Tensor:
    """[H, W, C] lat-long probe -> [6, res, res, C], bilinear (wraps in
    longitude, clamps in latitude)."""
    H, W = latlong.shape[:2]
    d = cube_dirs(res, latlong.device)
    theta = torch.arccos(d[..., 1].clamp(-1, 1))
    phi = torch.atan2(d[..., 0], -d[..., 2])
    y = theta / math.pi * H - 0.5
    x = (phi / (2 * math.pi) + 0.5) * W - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    # int32 truncation then floor-mod, as jnp.mod wraps a negative column
    xi0 = torch.remainder(x0.to(torch.int32), W).long()
    xi1 = torch.remainder(xi0 + 1, W)
    yi0 = y0.to(torch.int32).clamp(0, H - 1).long()
    yi1 = (yi0 + 1).clamp(0, H - 1)
    return (latlong[yi0, xi0] * ((1 - fx) * (1 - fy))
            + latlong[yi0, xi1] * (fx * (1 - fy))
            + latlong[yi1, xi0] * ((1 - fx) * fy)
            + latlong[yi1, xi1] * (fx * fy))


def cubemap_to_latlong(cube: torch.Tensor,
                       shape: Tuple[int, int]) -> torch.Tensor:
    """[6, res, res, C] -> [H, W, C], nearest texel of the major face."""
    H, W = shape
    dev = cube.device
    yy = (torch.arange(H, device=dev) + 0.5) / H * math.pi
    xx = ((torch.arange(W, device=dev) + 0.5) / W - 0.5) * 2 * math.pi
    th, ph = torch.meshgrid(yy, xx, indexing="ij")
    d = torch.stack([torch.sin(th) * torch.sin(ph), torch.cos(th),
                     -torch.sin(th) * torch.cos(ph)], -1)
    ax, ay, az = d[..., 0].abs(), d[..., 1].abs(), d[..., 2].abs()
    res = cube.shape[1]

    def pick(c, a, b):
        return torch.where(c, torch.as_tensor(a, device=dev),
                           torch.as_tensor(b, device=dev))

    xmaj = (ax >= ay) & (ax >= az)
    face = torch.where(
        xmaj, pick(d[..., 0] > 0, 0, 1),
        torch.where(ay >= az, pick(d[..., 1] > 0, 2, 3),
                    pick(d[..., 2] > 0, 4, 5)))
    major = torch.where(xmaj, ax, torch.where(ay >= az, ay, az))
    dn = d / major[..., None]
    uv_table = [
        (-dn[..., 2], -dn[..., 1]),   # +x
        (dn[..., 2], -dn[..., 1]),    # -x
        (dn[..., 0], dn[..., 2]),     # +y
        (dn[..., 0], -dn[..., 2]),    # -y
        (dn[..., 0], -dn[..., 1]),    # +z
        (-dn[..., 0], -dn[..., 1]),   # -z
    ]
    uu = torch.zeros_like(major)
    vv = torch.zeros_like(major)
    for i, (ui, vi) in enumerate(uv_table):
        uu = torch.where(face == i, ui, uu)
        vv = torch.where(face == i, vi, vv)
    col = ((uu + 1) * 0.5 * res).to(torch.int32).clamp(0, res - 1).long()
    row = ((vv + 1) * 0.5 * res).to(torch.int32).clamp(0, res - 1).long()
    return cube[face.long(), row, col]


def _prefilter_weights(res: int, device):
    d = cube_dirs(res, device).reshape(-1, 3)
    sa = texel_solid_angles(res, device).reshape(-1)
    return d, sa


def diffuse_prefilter(cube: torch.Tensor) -> torch.Tensor:
    """Cosine-convolved irradiance: out(n) = sum_l max(n.l, 0) L(l) dOmega
    / pi."""
    d, sa = _prefilter_weights(cube.shape[1], cube.device)
    src = cube.reshape(-1, cube.shape[-1])
    w = (d @ d.T).clamp_min(0.0) * sa[None, :]               # [Nd, Ns]
    return ((w @ src) / math.pi).reshape(cube.shape)


def _ggx_ndf(cos_h: torch.Tensor, alpha: float) -> torch.Tensor:
    a2 = alpha * alpha
    den = cos_h * cos_h * (a2 - 1.0) + 1.0
    return a2 / (math.pi * den * den).clamp_min(1e-9)


def specular_prefilter(cube: torch.Tensor, roughness: float) -> torch.Tensor:
    """GGX-NDF-weighted prefilter at one roughness with n = v = r:
    out(r) = sum_l D(r.l) (r.l) L(l) dOmega / sum of the weights."""
    d, sa = _prefilter_weights(cube.shape[1], cube.device)
    src = cube.reshape(-1, cube.shape[-1])
    cos_rl = (d @ d.T).clamp_min(0.0)
    # n = v = r: the half vector's cosine is sqrt((1 + cos_rl) / 2)
    cos_h = torch.sqrt(((1.0 + cos_rl) * 0.5).clamp(0.0, 1.0))
    w = _ggx_ndf(cos_h, max(roughness, 0.02) ** 2) * cos_rl * sa[None, :]
    norm = w.sum(1, keepdim=True).clamp_min(1e-9)
    return ((w @ src) / norm).reshape(cube.shape)


def specular_mip_chain(cube: torch.Tensor,
                       n_mips: int = 5) -> List[torch.Tensor]:
    """Prefiltered levels of rising roughness i / (n_mips - 1), each at
    half the resolution of the one before (down to a side of 2)."""
    mips = []
    cur = cube
    for i in range(n_mips):
        rough = i / max(n_mips - 1, 1)
        mips.append(specular_prefilter(cur, rough))
        if cur.shape[1] > 2 and i != n_mips - 1:
            res = cur.shape[1] // 2
            cur = cur.reshape(6, res, 2, res, 2, -1).mean(dim=(2, 4))
    return mips
