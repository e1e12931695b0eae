"""Inclusive float scan, plain PyTorch."""

from __future__ import annotations

import torch


def inclusive_scan(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0)
