"""Small constant tensors, made once per (value, dtype, device) and kept.

Building a tensor from host data on a CUDA device
(``torch.tensor([...], device=cuda)``, or indexing with a Python list)
copies it from pageable memory, and PyTorch waits for the device's
stream to drain before such a copy returns: one host synchronisation per
call. A step that makes its lookup tables and coefficient vectors that
way pays that many round trips a step. ``const`` makes each of them once.
The tensors it returns are shared: no caller writes into them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_CACHE: Dict[tuple, Tuple[object, torch.Tensor]] = {}


def const(values, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(values, dtype=dtype, device=device)``, made once.
    ``values``: a tuple of numbers (keyed by value) or a numpy array that
    is never written to, such as a module's table (keyed by identity,
    and kept alive with the tensor)."""
    device = torch.device(device)
    if isinstance(values, np.ndarray):
        key = ("array", id(values), dtype, device)
    else:
        values = tuple(values)
        key = ("tuple", values, dtype, device)
    hit = _CACHE.get(key)
    if hit is None:
        with torch.inference_mode(False):    # usable where autograd runs
            hit = (values, torch.as_tensor(values, dtype=dtype,
                                           device=device))
        _CACHE[key] = hit
    return hit[1]
