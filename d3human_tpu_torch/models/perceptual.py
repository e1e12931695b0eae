"""Perceptual losses (counterpart of ``d3human_tpu/models/perceptual.py``).

``ConvPerceptual``: a fixed 3-tap pyramid of 3x3 stride-2 SAME
convolutions with ReLU, compared by mean L1 per tap and averaged over the
taps. ``PyramidPerceptual``: the weight-free Laplacian-pyramid loss.
``NullPerceptual``: no perceptual term. ``make_perceptual`` picks one by
``loss.perceptual_backbone``, the MobileNetV2 features
(``models/mobilenet.py``) among them. ``LPIPSLike``: an LPIPS-style
distance over ConvPerceptual's taps.

Weights are PyTorch's OIHW ``[cout, cin, 3, 3]`` (``convert.py`` turns the
JAX package's HWIO filters into it); images are NHWC at the interface like
the JAX side. The convolution runs through
``torch.nn.functional.conv2d`` in float32 (the caller disables TF32 with
``torch.backends.cudnn.allow_tf32 = False``)."""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from d3human_tpu_torch.ops.scatter import gather_rows

Params = dict


def _conv_s2_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [N, C, H, W], 3x3 stride-2 SAME (the odd pad row/col goes at the
    end, as XLA pads)."""
    H, W = x.shape[-2:]
    pad_h = max((-(-H // 2) - 1) * 2 + 3 - H, 0)
    pad_w = max((-(-W // 2) - 1) * 2 + 3 - W, 0)
    x = F.pad(x, (pad_w // 2, pad_w - pad_w // 2,
                  pad_h // 2, pad_h - pad_h // 2))
    return F.conv2d(x, w, stride=2)


class ConvPerceptual:
    def __init__(self, channels: Sequence[int] = (24, 48, 96), seed: int = 7):
        self.channels = tuple(channels)
        self.seed = seed

    def init(self, device="cuda") -> Params:
        """Deterministic random filters N(0, 1) / sqrt(9 cin) from a numpy
        seed (the JAX package's own draws come in through convert.py)."""
        rng = np.random.default_rng(self.seed)
        dims = [3] + list(self.channels)
        ws = [torch.as_tensor((rng.normal(size=(cout, cin, 3, 3))
                               / np.sqrt(9 * cin)).astype(np.float32)
                              ).to(device)
              for cin, cout in zip(dims[:-1], dims[1:])]
        return {"ws": ws}

    def features(self, params: Params, img: torch.Tensor
                 ) -> List[torch.Tensor]:
        """img [N, H, W, 3] -> per-tap NCHW features."""
        x = img.permute(0, 3, 1, 2)
        feats = []
        for w in params["ws"]:
            x = torch.relu(_conv_s2_same(x, w))
            feats.append(x)
        return feats

    def loss(self, params: Params, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        fx = self.features(params, x)
        fy = self.features(params, y)
        losses = [(a - b).abs().mean() for a, b in zip(fx, fy)]
        return sum(losses) / len(losses)


def _blur_down(x: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Depthwise 5x5 binomial blur, stride 2, SAME (XLA's split of the
    padding: the odd row/column at the end); x NCHW."""
    C, H, W = x.shape[1:]
    ph = max((-(-H // 2) - 1) * 2 + 5 - H, 0)
    pw = max((-(-W // 2) - 1) * 2 + 5 - W, 0)
    x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    return F.conv2d(x, k2.expand(C, 1, 5, 5), stride=2, groups=C)


@functools.lru_cache(maxsize=64)
def _linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of ``F.interpolate``'s linear resize along one
    axis (align_corners=False, half-pixel centres, the source clamped at
    0 and its neighbour at the edge): two taps a row, position-dependent
    unless n_out = 2 n_in, so a matrix rather than a fixed stencil."""
    scale = n_in / n_out
    src = np.maximum((np.arange(n_out) + 0.5) * scale - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    lam = (src - i0).astype(np.float32)
    w = np.zeros((n_out, n_in), np.float32)
    np.add.at(w, (np.arange(n_out), i1), lam)
    np.add.at(w, (np.arange(n_out), i0), np.float32(1.0) - lam)
    return w


def upsample_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``F.interpolate(x, size, mode="bilinear", align_corners=False)`` of
    NCHW ``x`` as two products with fixed weight matrices (rows, then
    columns): their backward is two products, where the interpolation's
    own backward adds with atomics on a card."""
    h, w = x.shape[-2:]
    wy = torch.as_tensor(_linear_weights(h, size[0]), device=x.device)
    wx = torch.as_tensor(_linear_weights(w, size[1]), device=x.device)
    return wy @ x @ wx.T


class PyramidPerceptual:
    """Weight-free perceptual loss (JAX ``models/perceptual.py:107``): at
    each of ``n_levels`` scales the band-pass detail (the image minus its
    blurred, downsampled and linearly re-upsampled self) and the
    finite-difference gradients along x and y, then the low-pass residual;
    mean L1 per band, averaged over the bands."""

    def __init__(self, n_levels: int = 3):
        self.n_levels = n_levels
        k = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
        self._k2 = np.outer(k, k).astype(np.float32)

    def init(self, device="cuda") -> Params:
        return {}

    def _bands(self, x: torch.Tensor) -> List[torch.Tensor]:
        k2 = torch.as_tensor(self._k2, device=x.device)
        cur = x.permute(0, 3, 1, 2)
        bands = []
        for _ in range(self.n_levels):
            down = _blur_down(cur, k2)
            up = upsample_bilinear(down, cur.shape[-2:])
            bands.append(cur - up)
            bands.append(cur[..., :, 1:] - cur[..., :, :-1])
            bands.append(cur[..., 1:, :] - cur[..., :-1, :])
            cur = down
        bands.append(cur)
        return bands

    def loss(self, params: Params, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        bx, by = self._bands(x), self._bands(y)
        losses = [(a - b).abs().mean() for a, b in zip(bx, by)]
        return sum(losses) / len(losses)


class NullPerceptual:
    """No perceptual term: the loss is 0 (JAX ``models/perceptual.py:155``)."""

    def init(self, device="cuda") -> Params:
        return {}

    def loss(self, params: Params, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        return torch.zeros((), dtype=x.dtype, device=x.device)


class LPIPSLike:
    """LPIPS-style distance (JAX ``models/perceptual.py:174``): each tap's
    channel vector unit-normalised per pixel, the squared difference
    weighted per channel by ``lin`` (uniform 1/C unless an npz of
    ``lin_<i>`` arrays overrides it), summed over channels, averaged over
    space and over the taps."""

    def __init__(self, channels: Sequence[int] = (24, 48, 96),
                 seed: int = 11):
        self.backbone = ConvPerceptual(channels=channels, seed=seed)

    def init(self, weights_npz: Optional[str] = None,
             device="cuda") -> Params:
        params = {"backbone": self.backbone.init(device),
                  "lin": [torch.ones((c,), device=device) / c
                          for c in self.backbone.channels]}
        if weights_npz is not None and os.path.exists(weights_npz):
            with np.load(weights_npz) as z:
                params["lin"] = [
                    torch.as_tensor(np.array(z[f"lin_{i}"], np.float32))
                    .to(device) for i in range(len(self.backbone.channels))]
        return params

    def distance(self, params: Params, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
        fx = self.backbone.features(params["backbone"], x)
        fy = self.backbone.features(params["backbone"], y)
        total = 0.0
        for a, b, w in zip(fx, fy, params["lin"]):         # NCHW taps
            na = a / torch.sqrt((a * a).sum(1, keepdim=True) + 1e-10)
            nb = b / torch.sqrt((b * b).sum(1, keepdim=True) + 1e-10)
            total = total + (((na - nb) ** 2) * w[:, None, None]).sum(1) \
                .mean()
        return total / len(fx)


def make_perceptual(backbone: str, device="cuda",
                    perceptual_npz: Optional[str] = None):
    """(module, params) for ``loss.perceptual_backbone`` as the JAX driver
    picks them (``train_d3h.py:234-251``): "mobilenet" (its weights from
    ``perceptual_npz``, else the He-init fallback with a warning),
    "pyramid", "none", and ConvPerceptual for any other name."""
    if backbone == "mobilenet":
        from d3human_tpu_torch.models.mobilenet import MobileNetFeatures

        module = MobileNetFeatures()
        return module, module.init(perceptual_npz, device)
    module = {"pyramid": PyramidPerceptual,
              "none": NullPerceptual}.get(backbone, ConvPerceptual)()
    return module, module.init(device)


def random_crop_pair(generator: Optional[torch.Generator],
                     img_a: torch.Tensor, img_b: torch.Tensor, crop: int,
                     offsets: Optional[Tuple] = None):
    """The same random crop of two NHWC images. ``offsets = (top, left)``
    injects the corner; otherwise it is drawn from ``generator`` on the
    images' device and applied by index (no host read of the draw)."""
    H, W = img_a.shape[1:3]
    ch, cw = min(crop, H), min(crop, W)
    dev = img_a.device
    if offsets is None:
        top = torch.randint(0, max(H - crop, 1), (), generator=generator,
                            device=dev)
        left = torch.randint(0, max(W - crop, 1), (), generator=generator,
                             device=dev)
    else:
        top, left = (torch.as_tensor(o, device=dev).long() for o in offsets)
    # like a dynamic slice, a corner too far out is clamped into the image
    rows = top.clamp(0, H - ch) + torch.arange(ch, device=dev)
    cols = left.clamp(0, W - cw) + torch.arange(cw, device=dev)
    pix = (rows[:, None] * W + cols[None, :]).reshape(-1)

    def cut(img):
        # one row gather of the crop's pixels: its backward is the scatter
        N, C = img.shape[0], img.shape[3]
        table = img.permute(1, 2, 0, 3).reshape(H * W, N * C)
        return gather_rows(table, pix).reshape(ch, cw, N, C).permute(
            2, 0, 1, 3)

    return cut(img_a), cut(img_b)
