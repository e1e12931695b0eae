"""Static-capacity stream compaction, plain PyTorch: ``first_k_indices``
is ``jnp.nonzero(mask, size=k, fill_value=...)``, the ascending indices
of the first k set entries of a 1-D mask with the tail filled."""

from __future__ import annotations

import torch


def first_k_indices(mask: torch.Tensor, k: int,
                    fill_value: int) -> torch.Tensor:
    """int32 [k]: indices of the first k true entries of ``mask``
    (ascending), padded with ``fill_value``."""
    idx = torch.nonzero(mask.reshape(-1))[:k, 0].to(torch.int32)
    out = torch.full((k,), fill_value, dtype=torch.int32, device=mask.device)
    out[:idx.shape[0]] = idx
    return out
