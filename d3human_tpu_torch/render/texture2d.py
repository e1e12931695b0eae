"""Mipmapped 2D texture parameter and the UV-space bake (counterpart of
``d3human_tpu/render/texture2d.py``). The mip pyramid is rebuilt from the
base level at every sample (2x2 means), so the whole lookup is
differentiable without a custom backward. ``render_uv`` rasterizes the UV
unwrap as clip-space geometry through the oracle rasterizer (every pixel
tests every face; z = 0 and w = 1, so where charts touch, the lowest face
id wins), eight rows of texels at a time, so that each band tests only
the faces whose bounding box meets it; then it interpolates world
positions and samples the volume texture there."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from d3human_tpu_torch.ops.rasterizer import (
    barycentrics, interpolate, rasterize_bruteforce,
)


UV_ROWS = 8         # texel rows per pixel chunk of the UV rasterization


def build_mips(base: torch.Tensor, max_mip: int = 12) -> List[torch.Tensor]:
    """[H, W, C] -> the base and its 2x2-mean levels, down to a side of 1
    or ``max_mip`` levels (an odd row / column is dropped)."""
    mips = [base]
    while min(mips[-1].shape[:2]) > 1 and len(mips) < max_mip:
        m = mips[-1]
        H, W = m.shape[:2]
        m = m[: H - H % 2, : W - W % 2]
        mips.append(m.reshape(H // 2, 2, W // 2, 2, -1).mean(dim=(1, 3)))
    return mips


def _bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """img [H, W, C], uv [..., 2] in [0, 1] -> [..., C], clamped border."""
    H, W = img.shape[:2]
    x = uv[..., 0] * W - 0.5
    y = uv[..., 1] * H - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0 = x0.to(torch.int32).clamp(0, W - 1).long()
    y0 = y0.to(torch.int32).clamp(0, H - 1).long()
    x1 = (x0 + 1).clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    return (img[y0, x0] * ((1 - fx) * (1 - fy))
            + img[y0, x1] * (fx * (1 - fy))
            + img[y1, x0] * ((1 - fx) * fy)
            + img[y1, x1] * (fx * fy))


class Texture2D:
    """Trainable 2D texture with trilinear mip sampling and an optional
    clamp to (min [C], max [C])."""

    def __init__(self, min_max: Optional[Tuple[Sequence[float],
                                                Sequence[float]]] = None):
        self.min_max = min_max

    def init(self, gen: torch.Generator, res: Tuple[int, int],
             channels: int = 3, device="cuda") -> dict:
        return {"data": torch.rand((*res, channels), generator=gen)
                .to(device)}

    def _range(self, like: torch.Tensor):
        return tuple(torch.as_tensor(m, dtype=like.dtype, device=like.device)
                     for m in self.min_max)

    def sample(self, params: dict, uv: torch.Tensor, lod=0.0) -> torch.Tensor:
        """uv [..., 2] -> [..., C] at level of detail ``lod`` (a scalar;
        an array indexes the levels as ``jnp.take`` does, as in JAX)."""
        mips = build_mips(params["data"])
        lod = torch.as_tensor(lod, dtype=torch.float32,
                              device=uv.device).clamp(0, len(mips) - 1)
        lo = torch.floor(lod).to(torch.int32).long()
        frac = lod - lo
        samples = torch.stack([_bilinear(m, uv) for m in mips])
        a = samples[lo]
        b = samples[(lo + 1).clamp(max=len(mips) - 1)]
        out = a + (b - a) * frac
        if self.min_max is not None:
            mn, mx = self._range(out)
            out = torch.minimum(torch.maximum(out, mn), mx)
        return out

    def clamp(self, params: dict) -> dict:
        if self.min_max is None:
            return params
        mn, mx = self._range(params["data"])
        return {"data": torch.minimum(torch.maximum(params["data"], mn), mx)}


def render_uv(verts_pos: torch.Tensor, v_tex: torch.Tensor,
              t_tex_idx: torch.Tensor, t_pos_idx: torch.Tensor,
              resolution: Tuple[int, int], tex_module, tex_params):
    """Bake the volume texture into UV space: (mask [H, W, 1], kd
    [H, W, 3], ks [H, W, 3]). Faces keep their order."""
    uv_clip = torch.cat([v_tex * 2.0 - 1.0, torch.zeros_like(v_tex[..., :1]),
                         torch.ones_like(v_tex[..., :1])], dim=-1)
    fv = torch.ones((t_tex_idx.shape[0],), dtype=torch.bool,
                    device=v_tex.device)
    rast = rasterize_bruteforce(uv_clip, t_tex_idx, fv, resolution,
                                pixel_chunk=UV_ROWS * resolution[1])
    bary, cover = barycentrics(uv_clip, t_tex_idx, rast, resolution)
    gb_pos = interpolate(verts_pos, bary, t_pos_idx, rast)
    tex = tex_module.sample(tex_params, gb_pos)
    return cover[..., None].float(), tex[..., 0:3], tex[..., 3:6]
