"""Masked mesh operations on fixed-capacity buffers (counterpart of the
init- and split-path part of ``d3human_tpu/ops/mesh_ops.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from d3human_tpu_torch.ops.scatter import gather_rows, segment_add_rows


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=True),
                                          eps))


def face_normals(verts: torch.Tensor, faces: torch.Tensor,
                 normalize: bool = True) -> torch.Tensor:
    """One fused corner gather (scatter kernel in the backward)."""
    tri = gather_rows(verts, faces)                       # [F, 3, 3]
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    n = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    return safe_normalize(n) if normalize else n


def auto_normals(verts: torch.Tensor, faces: torch.Tensor,
                 face_valid: Optional[torch.Tensor] = None,
                 fn_raw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Area-weighted vertex normals: the unnormalized face normals of all
    three corners summed per vertex by ONE scatter (the scatter kernel in
    the forward). Degenerate normals fall back to +z. ``fn_raw`` passes
    precomputed unnormalized face normals."""
    fn = face_normals(verts, faces, normalize=False) if fn_raw is None \
        else fn_raw
    if face_valid is not None:
        fn = torch.where(face_valid[:, None], fn,
                         torch.zeros((), device=fn.device))
    v_nrm = segment_add_rows(fn.repeat(3, 1), faces.T.reshape(-1),
                             verts.shape[0])
    bad = (v_nrm * v_nrm).sum(-1, keepdim=True) <= 1e-20
    v_nrm = torch.where(bad, torch.tensor([0.0, 0.0, 1.0],
                                          device=fn.device), v_nrm)
    return safe_normalize(v_nrm)


def sample_points_on_mesh(
    verts: torch.Tensor, faces: torch.Tensor, n_samples: int,
    face_valid: Optional[torch.Tensor] = None,
    fn_raw: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Area-weighted surface samples [n, 3]: inverse-CDF over face areas,
    then uniform barycentrics. ``draws = (u [n], uv [n, 2])`` injects the
    uniform numbers (tests pass the JAX package's); otherwise they come
    from ``generator``. ``fn_raw`` = precomputed unnormalized normals."""
    fn = face_normals(verts, faces, normalize=False) if fn_raw is None \
        else fn_raw
    area = 0.5 * torch.sqrt(torch.clamp_min((fn * fn).sum(-1), 1e-20))
    if face_valid is not None:
        area = torch.where(face_valid, area, torch.zeros((), device=area.device))
    if draws is None:
        u01 = torch.rand((n_samples,), generator=generator,
                         device=verts.device)
        uv = torch.rand((n_samples, 2), generator=generator,
                        device=verts.device)
    else:
        u01, uv = (d.to(verts.device) for d in draws)
    cdf = torch.cumsum(area, 0)
    u = u01 * cdf[-1]
    fidx = torch.searchsorted(cdf, u).clamp(0, area.shape[0] - 1)
    su = torch.sqrt(uv[:, 0:1])
    b0 = 1.0 - su
    b1 = su * (1.0 - uv[:, 1:2])
    b2 = su * uv[:, 1:2]
    tri = verts[faces[fidx].long()]                       # [S, 3, 3]
    return b0 * tri[:, 0] + b1 * tri[:, 1] + b2 * tri[:, 2]
