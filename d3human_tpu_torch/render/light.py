"""Trainable lat-long environment light: the parameter and its clamp only
(counterpart of ``d3human_tpu/render/light.py:create_trainable_env`` and
``clamp_``). Albedo-only shading never reads the probe; the training step
carries it so the parameter tree and its post-step clamp match the JAX
package's. The sampling and the environment shading are not ported."""

from __future__ import annotations

import torch

Params = dict


def create_trainable_env(gen: torch.Generator, base_res: int = 256,
                         scale: float = 0.0, bias: float = 0.5,
                         device="cuda") -> Params:
    base = torch.rand((base_res, base_res, 3), generator=gen) * scale + bias
    return {"base": base.to(device)}


def clamp_(params: Params, min_val: float = 1e-4) -> None:
    """Post-step clamp, in place (a light of 0 kills its gradient)."""
    with torch.no_grad():
        params["base"].clamp_(min=min_val)
