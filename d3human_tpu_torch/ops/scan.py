"""Inclusive prefix sums along the last axis in a fixed order.

``inclusive_scan`` is a port-only kernel (no Pallas kernel of the JAX
package computes it): the JAX package takes the area CDF of its surface
sampling with ``jnp.cumsum`` (``d3human_tpu/ops/mesh_ops.py:168``) and the
light probe's sampling tables with it (``d3human_tpu/render/light.py:
update_pdf``); XLA adds in a fixed order, while ``torch.cumsum`` on a CUDA
float tensor adds in the order its tiles finish. On a CUDA tensor the
wrapper makes one call into ``csrc/scan.cu`` (tile sums, then each tile's
scan above the sum of the tiles before it; all sums in double, so the
result is near the exact prefix rounded once); on a CPU tensor it runs
``inclusive_scan_plain``, ``torch.cumsum``, which on the CPU also adds a
float input in double, in order. No gradient: the CDFs' callers only
search them.
"""

from __future__ import annotations

import ctypes

import torch

from d3human_tpu_torch.ops import cuda_lib

_PTR = ctypes.c_void_p
_SIG = {"d3h_inclusive_scan": (_PTR, ctypes.c_int, ctypes.c_longlong, _PTR,
                               _PTR, _PTR)}
TILE = 2048             # entries per CTA (csrc/scan.cu TILE)
LAUNCHES = 2            # kernel launches per call: tile sums, then scans


def inclusive_scan_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.cumsum`` along the last axis."""
    return torch.cumsum(x, -1)


def inclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """float32 [n] or [rows, n] -> the same shape, out[..., i] = x[..., 0]
    + ... + x[..., i]; not differentiable (``x`` is read detached)."""
    x = x.detach()
    dev = x.device
    if dev.type == "cpu":
        return inclusive_scan_plain(x)
    if dev.type != "cuda":
        raise ValueError(f"inclusive_scan: unsupported device {dev}")
    if x.dtype != torch.float32 or x.dim() not in (1, 2):
        raise ValueError(f"inclusive_scan: x must be float32 [n] or "
                         f"[rows, n], got {x.dtype} {tuple(x.shape)}")
    rows, n = (1, x.shape[0]) if x.dim() == 1 else x.shape
    if rows >= 2 ** 16:
        raise ValueError(f"inclusive_scan: {rows} rows (at most 65,535)")
    inclusive_scan.calls += 1
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    if n == 0 or rows == 0:
        return out
    x = x.contiguous()
    tile_sums = torch.empty((rows * -(-n // TILE),), dtype=torch.float64,
                            device=dev)
    cuda_lib.check(cuda_lib.load("scan", _SIG).d3h_inclusive_scan(
        x.data_ptr(), rows, n, tile_sums.data_ptr(), out.data_ptr(),
        cuda_lib.stream_ptr(dev)), "inclusive_scan")
    inclusive_scan.launches += LAUNCHES
    return out


inclusive_scan.launches = 0     # kernel launches (LAUNCHES per call)
inclusive_scan.calls = 0        # calls of the wrapper on CUDA tensors
