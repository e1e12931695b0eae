"""MobileNetV2 feature extractor, stages 0-7 of torchvision's width-1.0
``mobilenet_v2().features``, for the perceptual loss (counterpart of
``d3human_tpu/models/mobilenet.py``). The loss compares the taps (2, 4, 7)
by mean L1, averaged over the taps. BatchNorm is folded into the
convolutions when the weights are converted, so each stage is conv +
ReLU6 (the expansion, the depthwise 3x3 with ``groups=C``, the linear
projection and the residual where the shape allows).

Weights are PyTorch's OIHW (depthwise ``[C, 1, 3, 3]``). ``init(npz)``
reads the JAX package's npz (HWIO, BN folded; ``scripts/
convert_mobilenet.py`` writes it from a torchvision checkpoint) through
``convert.mobilenet_from_jax``. Without the npz it falls back to He-init
filters of the same shapes and fan-in, drawn from
``torch.Generator().manual_seed(seed)``: the port's own weights, not the
JAX package's draws (``convert.py`` carries those). Images are NHWC at the interface; the convolutions run
in float32 through ``torch.nn.functional.conv2d`` (the caller disables
TF32)."""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = dict

# (kind, stride, expand_ratio, c_in, c_out) of torchvision features[0..7]:
# 'conv' = ConvBNReLU 3x3, 'ir' = InvertedResidual
_STAGES: Tuple[Tuple[str, int, int, int, int], ...] = (
    ("conv", 2, 0, 3, 32),
    ("ir", 1, 1, 32, 16),
    ("ir", 2, 6, 16, 24),      # tap
    ("ir", 1, 6, 24, 24),
    ("ir", 2, 6, 24, 32),      # tap
    ("ir", 1, 6, 32, 32),
    ("ir", 1, 6, 32, 32),
    ("ir", 2, 6, 32, 64),      # tap
)
TAPS = (2, 4, 7)


def _conv2d(x, w, b, stride: int, groups: int = 1):
    # torchvision's symmetric padding (k - 1) // 2, not an asymmetric
    # "same" split, which would shift every stride-2 map half a pixel
    p = (w.shape[-1] - 1) // 2
    return F.conv2d(x, w, b, stride=stride, padding=p, groups=groups)


def _relu6(x):
    return x.clamp(0.0, 6.0)


def _stage_convs(kind: str, expand: int, c_in: int, c_out: int):
    """One stage's convolutions in order: (name, k, in_per_group, out,
    groups)."""
    if kind == "conv":
        return [("conv", 3, c_in, c_out, 1)]
    hidden = c_in * expand
    convs = [("expand", 1, c_in, hidden, 1)] if expand != 1 else []
    return convs + [("dw", 3, 1, hidden, hidden),
                    ("project", 1, hidden, c_out, 1)]


class MobileNetFeatures:
    """features[0..7] of MobileNetV2; ``features()`` returns the taps."""

    def __init__(self, seed: int = 3):
        self.seed = seed

    def init(self, npz_path: Optional[str] = None, device="cuda") -> Params:
        if npz_path and os.path.exists(npz_path):
            from d3human_tpu_torch.convert import mobilenet_from_jax

            with np.load(npz_path) as z:
                return mobilenet_from_jax({k: z[k] for k in z.files},
                                          device)
        if npz_path:
            # a named but missing npz is most often a wrong path; random
            # features train differently (the JAX package warns the same)
            print(f"[mobilenet] WARNING: weights npz '{npz_path}' not found "
                  f"— falling back to deterministic He-init (random) "
                  f"features", flush=True)
        gen = torch.Generator().manual_seed(self.seed)
        params = {}
        for si, (kind, _s, expand, c_in, c_out) in enumerate(_STAGES):
            for nm, k, ipg, out, _g in _stage_convs(kind, expand, c_in,
                                                     c_out):
                w = torch.randn((out, ipg, k, k), generator=gen) \
                    * np.sqrt(2.0 / (k * k * ipg))
                params[f"s{si}_{nm}_w"] = w.to(device)
                params[f"s{si}_{nm}_b"] = torch.zeros((out,), device=device)
        return params

    def features(self, params: Params, img: torch.Tensor
                 ) -> List[torch.Tensor]:
        """img [N, H, W, 3] -> NHWC feature maps at the taps. The normal
        images go in as they are (no ImageNet normalisation, as in the
        reference)."""
        x = img.permute(0, 3, 1, 2)
        feats = []
        for si, (kind, stride, expand, c_in, c_out) in enumerate(_STAGES):
            if kind == "conv":
                x = _relu6(_conv2d(x, params[f"s{si}_conv_w"],
                                   params[f"s{si}_conv_b"], stride))
            else:
                h = x
                if expand != 1:
                    h = _relu6(_conv2d(h, params[f"s{si}_expand_w"],
                                       params[f"s{si}_expand_b"], 1))
                h = _relu6(_conv2d(h, params[f"s{si}_dw_w"],
                                   params[f"s{si}_dw_b"], stride,
                                   groups=h.shape[1]))
                h = _conv2d(h, params[f"s{si}_project_w"],
                            params[f"s{si}_project_b"], 1)
                x = x + h if (stride == 1 and c_in == c_out) else h
            if si in TAPS:
                feats.append(x.permute(0, 2, 3, 1))
        return feats

    def loss(self, params: Params, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        """Mean L1 per tap, averaged over the taps."""
        fx, fy = self.features(params, x), self.features(params, y)
        losses = [(a - b).abs().mean() for a, b in zip(fx, fy)]
        return sum(losses) / len(losses)
