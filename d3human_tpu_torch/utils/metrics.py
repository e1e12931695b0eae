"""Evaluation metrics (counterpart of ``d3human_tpu/utils/metrics.py``):
Chamfer distance between point sets and between meshes, PSNR, IoU."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from d3human_tpu_torch.ops.image_loss import mse_to_psnr
from d3human_tpu_torch.ops.knn import knn1
from d3human_tpu_torch.ops.mesh_ops import sample_points_on_mesh


def chamfer_distance(a: torch.Tensor, b: torch.Tensor,
                     block: int = 4096) -> torch.Tensor:
    """Symmetric Chamfer-L2 between [Na, 3] and [Nb, 3]: the mean squared
    nearest-neighbour distance each way, summed (the blocked K=1 search
    ``knn1``; the distances are recomputed from the winners, so a tie
    broken either way gives the same value)."""
    d_ab, _ = knn1(a, b, block=block)
    d_ba, _ = knn1(b, a, block=block)
    return d_ab.mean() + d_ba.mean()


def mesh_chamfer(verts_a, faces_a, verts_b, faces_b, n_samples: int = 30000,
                 generator: Optional[torch.Generator] = None,
                 samples: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 device="cuda") -> float:
    """Chamfer between ``n_samples`` area-weighted surface samples of each
    mesh (arrays or tensors), drawn from ``generator`` (a fixed seed when
    None); ``samples = (pa, pb)`` injects the two point sets instead."""
    if samples is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)

        def t(a, dtype):
            return torch.as_tensor(a).to(device=device, dtype=dtype)

        pa = sample_points_on_mesh(t(verts_a, torch.float32),
                                   t(faces_a, torch.int64), n_samples,
                                   generator=generator)
        pb = sample_points_on_mesh(t(verts_b, torch.float32),
                                   t(faces_b, torch.int64), n_samples,
                                   generator=generator)
    else:
        pa, pb = samples
    with torch.no_grad():
        return float(chamfer_distance(pa, pb))


def psnr(img: torch.Tensor, ref: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PSNR over [0, 1] images; ``mask`` restricts the region."""
    err = (img - ref) ** 2
    if mask is not None:
        mse = (err * mask).sum() / torch.clamp_min(
            mask.sum() * img.shape[-1], 1.0)
    else:
        mse = err.mean()
    return mse_to_psnr(mse)


def iou(mask_a: torch.Tensor, mask_b: torch.Tensor,
        thresh: float = 0.5) -> torch.Tensor:
    a = mask_a > thresh
    b = mask_b > thresh
    inter = (a & b).sum()
    union = torch.clamp_min((a | b).sum(), 1)
    return inter / union
