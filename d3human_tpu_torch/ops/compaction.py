"""Static-capacity stream compaction: ``first_k_indices``.

Counterpart of ``d3human_tpu/ops/compaction.py``. Returns the ascending
indices of the first k set entries of a 1-D mask, the tail filled with
``fill_value`` — ``jnp.nonzero(mask, size=k, fill_value=...)`` — with a
static output size and no host synchronisation.

On a CUDA tensor the wrapper makes one call into ``csrc/first_k.cu`` (which
replaces the Pallas kernel ``d3human_tpu/ops/compaction.py:37
_first_k_kernel``; the source note there says what bounds it): a launch that
counts the set bytes of each tile of ``TILE_BYTES`` mask bytes, and one that
writes each tile's indices from the counts before it. The mask is read as
bytes, nonzero = set. On a CPU tensor it runs ``first_k_plain``. Unlike the
JAX path there is no n < 2^24 limit.
"""

from __future__ import annotations

import ctypes

import torch

from d3human_tpu_torch.ops import cuda_lib

_PTR = ctypes.c_void_p
_SIG = {"d3h_first_k": (_PTR, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                        _PTR, _PTR, _PTR)}
TILE_BYTES = 16384      # mask bytes per CTA (csrc/first_k.cu TILE_BYTES)
LAUNCHES = 2            # kernel launches per call: count, then write
_BYTES = (torch.bool, torch.uint8)


def first_k_plain(mask: torch.Tensor, k: int, fill_value: int) -> torch.Tensor:
    """Plain PyTorch version, the function's definition: the inclusive
    cumsum is the destination map (set entry of rank r lands in slot r-1),
    written with one scatter into a k+1-slot buffer (slot k absorbs the
    entries that do not land)."""
    mask = mask.reshape(-1).to(torch.bool)
    n = mask.shape[0]
    csum = torch.cumsum(mask, 0, dtype=torch.int32)
    lands = mask & (csum <= k)
    dest = torch.where(lands, csum.long() - 1, k)
    pos = torch.arange(n, dtype=torch.int32, device=mask.device)
    buf = torch.full((k + 1,), fill_value, dtype=torch.int32,
                     device=mask.device)
    buf.scatter_(0, dest, torch.where(lands, pos, fill_value))
    return buf[:k]


@cuda_lib.counted("first_k", _SIG)
def first_k_indices(mask: torch.Tensor, k: int,
                    fill_value: int) -> torch.Tensor:
    """int32 [k]: indices of the first k true entries of ``mask``
    (ascending), padded with ``fill_value``."""
    dev = mask.device
    if dev.type == "cpu":
        return first_k_plain(mask, k, fill_value)
    if dev.type != "cuda":
        raise ValueError(f"first_k_indices: unsupported device {dev}")
    n = mask.numel()
    if n >= 2 ** 31 or k >= 2 ** 31:
        raise ValueError("first_k_indices: n and k must fit int32")
    first_k_indices.calls += 1
    if n == 0 or k == 0:
        return torch.full((k,), fill_value, dtype=torch.int32, device=dev)
    if mask.dtype not in _BYTES:
        mask = mask != 0
    mask = mask.reshape(-1).contiguous()
    # out, then one count per tile of the first launch (the most tiles any
    # alignment of the mask's first byte can give)
    buf = torch.empty((k + (n + 15 + TILE_BYTES - 1) // TILE_BYTES,),
                      dtype=torch.int32, device=dev)
    out = buf.data_ptr()
    cuda_lib.launch(first_k_indices, "d3h_first_k", mask.data_ptr(), n, k,
                    int(fill_value), out, out + 4 * k, device=dev,
                    launches=LAUNCHES)
    return buf[:k]
