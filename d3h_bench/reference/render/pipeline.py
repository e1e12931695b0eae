"""Mesh rendering: rasterize -> interpolate -> shade -> composite
(counterpart of ``d3human_tpu/render/pipeline.py``).

``render_mesh`` dispatches between

* ``render_mesh_compact``, the training path: all per-pixel work on a
  static-capacity list of covered pixels, ONE fused vertex gather, ONE
  multi-channel image scatter, sparse silhouette antialiasing. Its lean
  branch (no shading, no labels, no smoothness taps) serves the init
  stage; its shaded branch (hash-grid texture, jittered smoothness taps)
  the split stage;
* ``render_mesh_full``, the dense validation path: every buffer at image
  size, ``spp`` supersampling, and ``layers`` 1-4 of depth peeling with the
  back-to-front composite and per-layer antialiasing.

Shading is albedo-only (``bsdf="kd"``, what the reference forces at run
time), the two-sided normal (``"normal"``) or the environment light
(``"pbr"``, full path only: ``render/envshade.py`` with ``light_params``,
optionally shadowed by an ``sdf_fn``). ``use_bruteforce_raster`` routes
the full path through the oracle rasterizer (``rasterize_bruteforce``).

Random draws (texture jitter ``0.01 N(0,1)``, normal-tap jitter
``0.005 N(0,1)``, and under ``"pbr"`` the light sampler's two uniform
vectors) come from ``generator`` unless ``draws = (n_tex, n_uv)`` or
``(n_tex, n_uv, (uy, ux))`` injects them (tests pass the JAX package's).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from d3h_bench.reference.ops import mesh_ops
from d3h_bench.reference.ops.compaction import first_k_indices
from d3h_bench.reference.ops.rasterizer import (
    Rast, aa_geometry_compact, aa_pair_candidates, aa_pairs_compact,
    aa_weights, apply_aa, apply_aa_sparse, avg_pool_nhwc, barycentrics,
    barycentrics_compact, compact_cover, interpolate, interpolate_face_attr,
    pixel_centers_at, rasterize, rasterize_bruteforce, scatter_image,
    visible_face_mask, xfm_points,
)
from d3h_bench.reference.ops.scatter import gather_rows, scatter_rows_sorted
from d3h_bench.reference.render.envshade import env_shade


class MeshBuffers(NamedTuple):
    shaded: torch.Tensor             # [H, W, 4] colour + alpha, composited + AA
    geometric_normal: torch.Tensor   # [H, W, 4] AA'd normals | AA alpha
    msdf_image: torch.Tensor         # [H, W, 1]
    alpha: torch.Tensor              # [H, W, 1] raw coverage (pre-AA)
    visible_faces: torch.Tensor      # [F] bool
    rast: Rast
    # compacted path only: per-covered-pixel arrays for the mean-based
    # regularizers and the capacity counters
    stats: Optional[dict] = None
    # buffers a path does not produce stay None (the compacted path makes
    # kd and mesh_id only when it shades; the rest is the full path's)
    kd: Optional[torch.Tensor] = None            # [H, W, 4]
    mesh_id: Optional[torch.Tensor] = None       # [H, W, 1] (no AA)
    diffuse_light: Optional[torch.Tensor] = None   # [H, W, 3] zeros under kd
    specular_light: Optional[torch.Tensor] = None  # [H, W, 3]
    normal: Optional[torch.Tensor] = None        # [H, W, 4] smooth, two-sided
    depth: Optional[torch.Tensor] = None         # [H, W, 2]
    invdepth: Optional[torch.Tensor] = None      # [H, W, 2]
    ks: Optional[torch.Tensor] = None            # [H, W, 4]
    kd_grad: Optional[torch.Tensor] = None       # [H, W, 4]
    ks_grad: Optional[torch.Tensor] = None       # [H, W, 4]
    normal_grad: Optional[torch.Tensor] = None   # [H, W, 4]


def _randn(shape, like: torch.Tensor, generator, draw):
    """Standard normals of ``shape``: the injected draw, else the generator."""
    if draw is not None:
        if tuple(draw.shape) != tuple(shape):
            raise ValueError(f"injected draw has shape {tuple(draw.shape)}, "
                             f"expected {tuple(shape)}")
        return draw.to(like.device, like.dtype)
    return torch.randn(tuple(shape), generator=generator, device=like.device,
                       dtype=like.dtype)


def _bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """img [H, W, C], uv [..., 2] in [0, 1] -> [..., C] (clamped border).
    The 4 corner taps run as ONE fused row gather of the flattened image,
    so the backward is a single scatter-kernel call."""
    H, W = img.shape[:2]
    x = uv[..., 0] * W - 0.5
    y = uv[..., 1] * H - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0 = x0.to(torch.int32).clamp(0, W - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    y0 = y0.to(torch.int32).clamp(0, H - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    rows = torch.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1])
    wts = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy),
                       (1 - fx) * fy, fx * fy])
    g = gather_rows(img.reshape(H * W, -1), rows)               # [4, ..., C]
    return (g * wts[..., None]).sum(0)


def render_mesh(
    generator: Optional[torch.Generator],
    verts: torch.Tensor,             # [V, 3] posed vertex positions
    verts_original: torch.Tensor,    # [V, 3] canonical positions (texture)
    faces: torch.Tensor,             # [F, 3]
    face_valid: torch.Tensor,        # [F]
    mvp: torch.Tensor,               # [4, 4]
    campos: torch.Tensor,            # [3]
    resolution: Tuple[int, int],
    tex_module,                      # MLPTexture3D
    tex_params,
    background: torch.Tensor,        # [H, W, 3]
    msdf_attr: Optional[torch.Tensor] = None,    # [V]
    face_labels: Optional[torch.Tensor] = None,  # [F] 0 = body, 1 = cloth
    v_nrm: Optional[torch.Tensor] = None,        # [V, 3] smooth normals
    spp: int = 1,
    use_bruteforce_raster: bool = False,
    raster_opts: Optional[dict] = None,
    max_covered_frac: float = 0.5,
    aa_all_buffers: bool = False,
    bsdf: str = "kd",
    light_params=None,
    n_light_samples: int = 8,
    shadow_scale: float = 1.0,
    sdf_fn=None,
    compact: Optional[bool] = None,
    aa_max_pairs: Optional[int] = None,
    aa_z_thresh: float = 0.01,
    jitter_subsample: int = 2,
    shade: bool = True,
    layers: int = 1,
    aa_dense: bool = False,
    need_smoothness: bool = True,
    draws=None,
) -> MeshBuffers:
    """The compacted training path where it applies (the default), else the
    full-image path (validation, spp > 1, layers > 1, ``bsdf="pbr"``)."""
    if compact is None:
        compact = (spp == 1 and bsdf == "kd" and not use_bruteforce_raster
                   and not aa_all_buffers and 0 < max_covered_frac < 1
                   and layers == 1)
    if compact:
        return render_mesh_compact(
            generator, verts, verts_original, faces, face_valid, mvp, campos,
            resolution, tex_module, tex_params, background,
            msdf_attr=msdf_attr, face_labels=face_labels, v_nrm=v_nrm,
            raster_opts=raster_opts, max_covered_frac=max_covered_frac,
            aa_max_pairs=aa_max_pairs, aa_z_thresh=aa_z_thresh,
            jitter_subsample=jitter_subsample, shade=shade,
            aa_dense=aa_dense, need_smoothness=need_smoothness, draws=draws)
    return render_mesh_full(
        generator, verts, verts_original, faces, face_valid, mvp, campos,
        resolution, tex_module, tex_params, background, shade=shade,
        msdf_attr=msdf_attr, face_labels=face_labels, v_nrm=v_nrm, spp=spp,
        use_bruteforce_raster=use_bruteforce_raster, raster_opts=raster_opts,
        max_covered_frac=max_covered_frac, aa_all_buffers=aa_all_buffers,
        bsdf=bsdf, light_params=light_params,
        n_light_samples=n_light_samples, shadow_scale=shadow_scale,
        sdf_fn=sdf_fn, layers=layers, draws=draws)


def _antialias_compact(aa_in, v_clip, faces, rast, resolution, aa_max_pairs,
                       aa_z_thresh, aa_dense):
    """Silhouette antialiasing of the compacted path: the compacted pair
    list per axis, or every pair when ``aa_dense``. Returns (image, the two
    per-axis candidate counts, the capacity they are held against)."""
    H, W = resolution
    if aa_max_pairs is None:
        aa_max_pairs = 16 * max(H, W)
    if aa_dense:
        aa_out = apply_aa(aa_in, aa_weights(v_clip, faces, rast, resolution))
        counts = [aa_pair_candidates(rast, ax, aa_z_thresh).sum()
                  for ax in (1, 0)]
        return aa_out, counts, H * (W - 1)
    pairs, counts = [], []
    for axis in (1, 0):
        pidx, pvalid, n_cand = aa_pairs_compact(
            rast, resolution, axis, aa_max_pairs, aa_z_thresh)
        pairs.append(aa_geometry_compact(v_clip, faces, rast, pidx, pvalid,
                                         resolution, axis))
        counts.append(n_cand)
    return apply_aa_sparse(aa_in, pairs), counts, aa_max_pairs


def render_mesh_compact(
    generator: Optional[torch.Generator],
    verts: torch.Tensor,
    verts_original: torch.Tensor,
    faces: torch.Tensor,
    face_valid: torch.Tensor,
    mvp: torch.Tensor,
    campos: torch.Tensor,
    resolution: Tuple[int, int],
    tex_module,
    tex_params,
    background: torch.Tensor,
    msdf_attr: Optional[torch.Tensor] = None,
    face_labels: Optional[torch.Tensor] = None,
    v_nrm: Optional[torch.Tensor] = None,
    raster_opts: Optional[dict] = None,
    max_covered_frac: float = 0.5,
    aa_max_pairs: Optional[int] = None,
    aa_z_thresh: float = 0.01,
    jitter_subsample: int = 2,
    shade: bool = True,
    aa_dense: bool = False,
    need_smoothness: bool = True,
    draws=None,
) -> MeshBuffers:
    """Covered-pixel-compacted render. Buffers no loss tick uses (depth,
    the smooth-normal image, ks and the smoothness images) stay None: the
    full path makes them."""
    H, W = resolution
    npix = H * W
    dev = verts.device
    v_clip = xfm_points(verts, mvp)
    rast = rasterize(v_clip, faces, face_valid, resolution,
                     **(raster_opts or {}))
    P = int(npix * max_covered_frac)
    idx, valid, fid = compact_cover(rast, P)
    pix_xy = pixel_centers_at(idx.clamp(max=npix - 1), resolution)
    vmask = valid[:, None].float()

    fn_raw = mesh_ops.face_normals(verts, faces, normalize=False)
    msdf_v = (msdf_attr[:, None] if msdf_attr is not None
              else torch.zeros((verts.shape[0], 1), device=dev))
    cover = rast.tri_id > 0
    alpha = cover[..., None].float()
    stats = {"idx": idx, "valid": valid, "fn_raw": fn_raw, "npix": npix,
             "n_cov": cover.sum(), "cov_capacity": P,
             "aa_dense": 1.0 if aa_dense else 0.0}

    # ---- lean init-stage branch: shading off, no labels, no smoothness
    # consumers => only geometric normals and the mSDF reach the losses
    if not shade and face_labels is None and not need_smoothness:
        vattr = torch.cat([v_clip, verts, msdf_v], dim=-1)          # [V, 8]
        g = gather_rows(vattr, faces[fid.long()])                   # [P, 3, 8]
        bary = barycentrics_compact(g[..., :4], pix_xy, resolution)
        interp = torch.einsum("pk,pkc->pc", bary, g[..., 4:])
        msdf_pix = interp[:, 3:4] * vmask
        geo_n = mesh_ops.safe_normalize(gather_rows(fn_raw, fid)) * vmask
        img = scatter_image(torch.cat([geo_n, msdf_pix], dim=-1), idx,
                            resolution)
        aa_out, aa_counts, aa_cap = _antialias_compact(
            torch.cat([alpha, img], dim=-1), v_clip, faces, rast, resolution,
            aa_max_pairs, aa_z_thresh, aa_dense)
        aa_alpha = aa_out[..., 0:1]
        shaded = torch.cat([background * (1.0 - aa_alpha), aa_alpha], dim=-1)
        geo_b = torch.cat([aa_out[..., 1:4], aa_alpha], dim=-1)
        stats.update(aa_pairs_x=aa_counts[0], aa_pairs_y=aa_counts[1],
                     aa_capacity=aa_cap)
        return MeshBuffers(
            shaded=shaded, geometric_normal=geo_b,
            msdf_image=aa_out[..., 4:5], alpha=alpha,
            visible_faces=visible_face_mask(rast, faces.shape[0]),
            rast=rast, stats=stats)

    # the corner gather behind fn_raw also serves the vertex normals and,
    # through stats, the eikonal sampler's face areas
    if v_nrm is None:
        v_nrm = mesh_ops.auto_normals(verts, faces, face_valid, fn_raw=fn_raw)

    # ---- ONE fused vertex gather (backward = one scatter-kernel call)
    vattr = torch.cat([v_clip, verts, verts_original, v_nrm, msdf_v],
                      dim=-1)                                        # [V, 14]
    g = gather_rows(vattr, faces[fid.long()])                       # [P, 3, 14]
    bary = barycentrics_compact(g[..., :4], pix_xy, resolution)
    interp = torch.einsum("pk,pkc->pc", bary, g[..., 4:])
    pos = interp[:, 0:3] * vmask
    pos_orig = interp[:, 3:6] * vmask
    nrm_s = interp[:, 6:9] * vmask
    msdf_pix = interp[:, 9:10] * vmask

    # ---- face-attribute gather
    flab = (face_labels.float()[:, None] if face_labels is not None
            else torch.zeros((faces.shape[0], 1), device=dev))
    fattr = gather_rows(
        torch.cat([mesh_ops.safe_normalize(fn_raw), flab], dim=-1), fid)
    geo_n = fattr[:, :3] * vmask
    mesh_id_pix = fattr[:, 3:4] * vmask

    # ---- texture + jittered smoothness taps on every sub-th covered pixel
    sub = slice(None, None, jitter_subsample)
    d_tex, d_uv = draws if draws is not None else (None, None)
    if shade:
        tex = tex_module.sample(tex_params, pos_orig) * vmask       # [P, 6]
        pts_h = pos_orig[sub]
        noise = 0.01 * _randn(pts_h.shape, pts_h, generator, d_tex)
        tex_j = tex_module.sample(tex_params, pts_h + noise)
        tex_d = (tex_j - tex[sub]).abs() * vmask[sub]
    else:
        tex = torch.zeros((P, 6), device=dev)
        tex_d = torch.zeros((pos_orig[sub].shape[0], 6), device=dev)
    kd_pix, ks_pix = tex[:, 0:3], tex[:, 3:6]
    kd_grad_pix = tex_d[:, 0:3]
    ks_grad_pix = tex_d[:, 3:6] * torch.tensor([0.0, 1.0, 1.0], device=dev)

    # ---- the image-consumed channels, scattered ONCE:
    # [rgb(3) | geo_n(3) | msdf(1) | nrm_s(3, pre-flip) | kd(3) | mesh_id(1)]
    packed = torch.cat([kd_pix, geo_n, msdf_pix, nrm_s, kd_pix, mesh_id_pix],
                       dim=-1)
    img = scatter_image(packed, idx, resolution)                    # [H, W, 14]

    # ---- normal-smoothness jitter tap: normal + alpha share one fused
    # 4-channel bilinear gather
    uv = pix_xy[sub] / torch.tensor([W, H], dtype=torch.float32, device=dev)
    jit_uv = uv + 0.005 * _randn(uv.shape, uv, generator, d_uv)
    na_tap = _bilinear_sample(torch.cat([img[..., 7:10], alpha], dim=-1),
                              jit_uv)
    nrm_grad_pix = ((na_tap[..., :3] - nrm_s[sub]).abs() * na_tap[..., 3:]
                    * vmask[sub])

    # ---- composite + antialias [rgb | alpha | geo_n | msdf]
    shaded_rgb = img[..., 0:3] + background * (1.0 - alpha)
    aa_out, aa_counts, aa_cap = _antialias_compact(
        torch.cat([shaded_rgb, alpha, img[..., 3:6], img[..., 6:7]], dim=-1),
        v_clip, faces, rast, resolution, aa_max_pairs, aa_z_thresh, aa_dense)
    aa_alpha = aa_out[..., 3:4]
    stats.update(
        kd=kd_pix, ks=ks_pix, kd_grad=kd_grad_pix, ks_grad=ks_grad_pix,
        nrm_grad=nrm_grad_pix, valid_sub=valid[sub],
        jitter_subsample=jitter_subsample,
        aa_pairs_x=aa_counts[0], aa_pairs_y=aa_counts[1], aa_capacity=aa_cap)
    return MeshBuffers(
        shaded=aa_out[..., 0:4],
        geometric_normal=torch.cat([aa_out[..., 4:7], aa_alpha], dim=-1),
        msdf_image=aa_out[..., 7:8], alpha=alpha,
        visible_faces=visible_face_mask(rast, faces.shape[0]),
        rast=rast, stats=stats,
        kd=torch.cat([img[..., 10:13], alpha], dim=-1),
        mesh_id=img[..., 13:14])


def render_mesh_full(
    generator: Optional[torch.Generator],
    verts: torch.Tensor,
    verts_original: torch.Tensor,
    faces: torch.Tensor,
    face_valid: torch.Tensor,
    mvp: torch.Tensor,
    campos: torch.Tensor,
    resolution: Tuple[int, int],
    tex_module,
    tex_params,
    background: torch.Tensor,
    msdf_attr: Optional[torch.Tensor] = None,
    face_labels: Optional[torch.Tensor] = None,
    v_nrm: Optional[torch.Tensor] = None,
    spp: int = 1,
    use_bruteforce_raster: bool = False,
    raster_opts: Optional[dict] = None,
    max_covered_frac: float = 0.5,
    aa_all_buffers: bool = False,
    bsdf: str = "kd",
    shade: bool = True,
    layers: int = 1,
    draws=None,
    light_params=None,
    n_light_samples: int = 8,
    shadow_scale: float = 1.0,
    sdf_fn=None,
) -> MeshBuffers:
    """Every buffer at image size. With ``layers > 1`` the rasterizer
    depth-peels; all per-pixel buffers come from the NEAREST layer and the
    shaded buffer is re-composited back to front across the layers, each
    antialiased against its own silhouette.

    ``bsdf="pbr"`` shades by ``env_shade`` under ``light_params`` with
    ``n_light_samples`` samples, shadowed by ``sdf_fn`` (points -> SDF,
    positive inside) scaled by ``shadow_scale``: diffuse light times
    ``kd * (1 - metalness)`` plus specular light. As in the JAX package,
    ``bsdf="pbr"`` with ``light_params=None`` renders ``kd`` (and zero
    light buffers), and the layers behind the nearest one are painted
    with ``kd``."""
    if bsdf not in ("kd", "normal", "pbr"):
        raise NotImplementedError(f"bsdf={bsdf!r}: only 'kd', 'normal' and "
                                  "'pbr' shade")
    H, W = resolution
    full_res = (H * spp, W * spp)
    dev = verts.device
    zero = torch.zeros((), device=dev)

    v_clip = xfm_points(verts, mvp)
    if use_bruteforce_raster:
        rast = rasterize_bruteforce(v_clip, faces, face_valid, full_res,
                                    layers=layers)
    else:
        rast = rasterize(v_clip, faces, face_valid, full_res, layers=layers,
                         **(raster_opts or {}))
    rast_layers = rast if layers > 1 else (rast,)
    rast = rast_layers[0]
    bary, cover = barycentrics(v_clip, faces, rast, full_res)
    mask = cover[..., None].float()

    # ---- interpolated geometry buffers
    gb_pos = interpolate(verts, bary, faces, rast)
    gb_pos_orig = interpolate(verts_original, bary, faces, rast)
    fn = mesh_ops.face_normals(verts, faces)
    gb_geo_normal = interpolate_face_attr(fn, rast)
    if v_nrm is None:
        v_nrm = mesh_ops.auto_normals(verts, faces, face_valid)
    gb_normal = interpolate(v_nrm, bary, faces, rast)

    def two_sided(normal, geo_normal, pos):
        flip = (geo_normal * (campos - pos)).sum(-1, keepdim=True) < 0
        return mesh_ops.safe_normalize(torch.where(flip, -normal, normal))

    gb_normal_ts = two_sided(gb_normal, gb_geo_normal, gb_pos)

    # ---- texture lookups: only covered pixels need texture, so compact
    # them (static capacity) before the lookup; the rest gets zeros
    d_tex, d_uv, d_light = (tuple(draws) + (None,))[:3] \
        if draws is not None else (None, None, None)
    npix = full_res[0] * full_res[1]
    max_cov = int(npix * max_covered_frac) if max_covered_frac else npix
    if not shade:
        tex = torch.zeros((*full_res, 6), device=dev)
        tex_j = tex
    elif max_cov < npix:
        cov_idx = first_k_indices(cover.reshape(-1), max_cov, npix).long()
        pts = gather_rows(torch.cat([gb_pos_orig.reshape(-1, 3),
                                     torch.zeros((1, 3), device=dev)]),
                          cov_idx)
        tex_c = tex_module.sample(tex_params, pts)

        def scatter(vals, idx):
            # a plain set at ascending pixels: the fill slots all carry
            # index npix, which is dropped
            return scatter_rows_sorted(vals, idx, npix).reshape(*full_res,
                                                                 -1)

        tex = scatter(tex_c, cov_idx)
        # jittered smoothness tap on every 2nd covered pixel; |jitter - base|
        # is scattered so unsampled pixels contribute 0
        pts_h = pts[::2]
        noise = 0.01 * _randn(pts_h.shape, pts_h, generator, d_tex)
        diff = (tex_module.sample(tex_params, pts_h + noise)
                - tex_c[::2]).abs()
        tex_j = tex + scatter(diff, cov_idx[::2])
    else:
        tex = tex_module.sample(tex_params, gb_pos_orig)
        noise = 0.01 * _randn(gb_pos_orig.shape, gb_pos_orig, generator,
                              d_tex)
        tex_j = tex_module.sample(tex_params, gb_pos_orig + noise)
    kd, ks = tex[..., 0:3], tex[..., 3:6]
    kd_grad = (tex_j[..., 0:3] - kd).abs()
    ks_grad = ((tex_j[..., 3:6] - ks).abs()
               * torch.tensor([0.0, 1.0, 1.0], device=dev))

    # ---- jittered normal smoothness
    vv, uu = torch.meshgrid(
        (torch.arange(full_res[0], device=dev) + 0.5) / full_res[0],
        (torch.arange(full_res[1], device=dev) + 0.5) / full_res[1],
        indexing="ij")
    pix_uv = torch.stack([uu, vv], dim=-1)
    jit_uv = pix_uv + 0.005 * _randn(pix_uv.shape, pix_uv, generator, d_uv)
    nrm_tap = _bilinear_sample(gb_normal, jit_uv)
    mask_tap = _bilinear_sample(mask, jit_uv)
    nrm_grad = (nrm_tap - gb_normal).abs() * (mask * mask_tap)

    # ---- scalar buffers
    alpha = mask
    dist = torch.sqrt(((gb_pos - campos) ** 2).sum(-1, keepdim=True) + 1e-12)
    depth = torch.where(cover[..., None], dist, zero)
    invdepth = torch.where(cover[..., None], 1.0 / dist.clamp_min(1e-8), zero)
    msdf_img = (interpolate(msdf_attr[:, None], bary, faces, rast)
                if msdf_attr is not None
                else torch.zeros((*full_res, 1), device=dev))
    mesh_id = (interpolate_face_attr(face_labels.float()[:, None], rast)
               if face_labels is not None
               else torch.zeros((*full_res, 1), device=dev))

    # ---- composite + antialias: the AA edge geometry does not depend on
    # the colour, so it is computed once per layer and applied per buffer
    ones = torch.ones_like(alpha)
    weights = aa_weights(v_clip, faces, rast, full_res)

    def comp(color, bg, aa=True):
        rgba = torch.cat([bg + (color - bg) * alpha, alpha], dim=-1)
        return apply_aa(rgba, weights) if aa else rgba

    zero3 = torch.zeros_like(kd)
    diffuse_l = specular_l = zero3
    if bsdf == "pbr" and light_params is not None:
        diffuse_l, specular_l = env_shade(
            generator, gb_pos, gb_normal_ts, campos, kd, ks, light_params,
            n_samples=n_light_samples, sdf_fn=sdf_fn,
            shadow_scale=shadow_scale, draws=d_light)
        shaded_col = diffuse_l * (kd * (1.0 - ks[..., 2:3])) + specular_l
    elif bsdf == "normal":
        shaded_col = (gb_normal_ts + 1.0) * 0.5
    else:
        shaded_col = kd
    shaded = comp(shaded_col, background)
    if layers > 1:
        # far layers are painted first; each nearer layer lerps over the
        # accumulator by its own coverage, then antialiases against its own
        # silhouette
        accum = torch.cat([background, torch.zeros_like(alpha)], dim=-1)
        for rl in reversed(rast_layers):
            bary_l, cover_l = barycentrics(v_clip, faces, rl, full_res)
            if bsdf == "normal":
                col_l = (two_sided(interpolate(v_nrm, bary_l, faces, rl),
                                   interpolate_face_attr(fn, rl),
                                   interpolate(verts, bary_l, faces, rl))
                         + 1.0) * 0.5
            elif shade:
                col_l = tex_module.sample(
                    tex_params,
                    interpolate(verts_original, bary_l, faces, rl))[..., 0:3]
            else:
                col_l = torch.zeros((*full_res, 3), device=dev)
            layer_rgba = torch.cat([col_l, ones], dim=-1)
            accum = accum + (layer_rgba - accum) * cover_l[..., None].float()
            accum = apply_aa(accum, aa_weights(v_clip, faces, rl, full_res))
        shaded = accum
    # depth buffers: alpha forced 1 to avoid double blending
    depth_b = torch.cat([20.0 + (depth - 20.0) * alpha, ones], dim=-1)
    invd_b = torch.cat([invdepth * alpha, ones], dim=-1)
    if aa_all_buffers:
        depth_b = apply_aa(depth_b, weights)
        invd_b = apply_aa(invd_b, weights)
    msdf_b = apply_aa(torch.cat([msdf_img * alpha, alpha], dim=-1),
                      weights)[..., :1]

    out = MeshBuffers(
        shaded=shaded, geometric_normal=comp(gb_geo_normal, zero3),
        msdf_image=msdf_b, alpha=alpha,
        visible_faces=visible_face_mask(rast, faces.shape[0]), rast=rast,
        kd=comp(kd, zero3, aa=aa_all_buffers),
        mesh_id=mesh_id,                    # NOT antialiased
        diffuse_light=diffuse_l, specular_light=specular_l,
        normal=comp(gb_normal_ts, zero3, aa=aa_all_buffers),
        depth=depth_b[..., :2], invdepth=invd_b[..., :2],
        ks=comp(ks, zero3, aa=aa_all_buffers),
        kd_grad=comp(kd_grad, zero3, aa=aa_all_buffers),
        ks_grad=comp(ks_grad, zero3, aa=aa_all_buffers),
        normal_grad=comp(nrm_grad, zero3, aa=aa_all_buffers))
    if spp > 1:
        out = MeshBuffers(*[
            avg_pool_nhwc(b, spp) if isinstance(b, torch.Tensor)
            and b.dim() == 3 and b.shape[0] == full_res[0] else b
            for b in out])
    return out
