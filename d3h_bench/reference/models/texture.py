"""Multiresolution hash-grid neural texture (counterpart of
``d3human_tpu/models/texture.py``): an Instant-NGP style feature grid with
an 8-corner trilinear blend per level, and a small bias-free ReLU MLP whose
output a sigmoid squashes into the [min, max] material range.

Dense levels (the grid fits the table) pack all 8 cell corners into one
row of ``8 * n_features`` floats, built per call from the canonical
``[S, F]`` table with 8 rolls and a concat, so a lookup is ONE
``gather_rows`` per level and point; its backward is the sorted-COO scatter
kernel into the packed rows, and the rolls' own backward carries that to
the canonical table. Hashed levels take 8 hashed gathers.

Quirks of the reference kept: ``sample`` normalises by the hard-coded bbox
of the config; the gradient entering the encoding is multiplied by
``gradient_scaling`` (128), which the optimizer's ``hashgrid_grad_scale``
(1/8) on the tables partly undoes.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from d3h_bench.reference.ops.scatter import gather_rows

Params = dict

_PRIMES = (1, 2654435761, 805459861)
_CORNERS = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def grad_scale(x: torch.Tensor, s: float) -> torch.Tensor:
    """Identity whose backward multiplies the gradient by ``s``."""
    return _GradScale.apply(x, s)


class HashGridEncoding:
    def __init__(self, n_levels=5, n_features=2, log2_hashmap_size=21,
                 base_resolution=16, desired_resolution=4096,
                 ref_levels_for_scale=16):
        # per_level_scale as the reference computes it: from a 16-level
        # schedule even though fewer levels are instantiated
        self.per_level_scale = math.exp(
            math.log(desired_resolution / base_resolution)
            / (ref_levels_for_scale - 1))
        self.n_levels = n_levels
        self.n_features = n_features
        self.table_size = 2 ** log2_hashmap_size
        self.resolutions = tuple(
            int(math.floor(base_resolution * self.per_level_scale ** lv))
            for lv in range(n_levels))
        self.dense = tuple((r + 1) ** 3 <= self.table_size
                           for r in self.resolutions)
        self.level_sizes = tuple(min((r + 1) ** 3, self.table_size)
                                 for r in self.resolutions)
        self.out_dim = n_levels * n_features

    def init(self, gen: torch.Generator, device="cuda") -> Params:
        """U(-1e-4, 1e-4) per level (drawn on the generator's device)."""
        return {"table": [
            ((torch.rand((s, self.n_features), generator=gen, device=gen.device) * 2.0 - 1.0)
             * 1e-4).to(device) for s in self.level_sizes]}

    def _corner_index(self, level: int, ix: torch.Tensor) -> torch.Tensor:
        """ix [..., 3] integer lattice coords -> table row."""
        if self.dense[level]:
            stride = self.resolutions[level] + 1
            return (ix[..., 0] * stride + ix[..., 1]) * stride + ix[..., 2]
        # the spatial hash relies on uint32 wraparound: int64 products,
        # each masked to 32 bits
        ix = ix.long()
        m = 0xFFFFFFFF
        h = (ix[..., 0] * _PRIMES[0]) & m
        h = h ^ ((ix[..., 1] * _PRIMES[1]) & m)
        h = h ^ ((ix[..., 2] * _PRIMES[2]) & m)
        return h & (self.table_size - 1)

    def packed_table(self, table_l: torch.Tensor, level: int) -> torch.Tensor:
        """[S, F] canonical table -> [S, 8*F] corner-packed rows:
        packed[r, c*F:(c+1)*F] = table[r + offset(corner c)]. The rolls wrap
        at the end, but wrapped rows are only gathered with zero weight."""
        s = self.resolutions[level] + 1
        return torch.cat([torch.roll(table_l, -(i * s * s + j * s + k), 0)
                          for (i, j, k) in _CORNERS], dim=-1)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x [..., 3] in [0, 1] -> [..., n_levels * n_features]."""
        F = self.n_features
        corners = torch.tensor(_CORNERS, device=x.device)
        outs = []
        for level, table_l in enumerate(params["table"]):
            xs = x * self.resolutions[level]
            x0 = torch.floor(xs)
            f = (xs - x0)[..., None, :]
            x0 = x0.to(torch.int32)
            cw = torch.where(corners > 0, f, 1.0 - f)            # [..., 8, 3]
            weight = cw[..., 0] * cw[..., 1] * cw[..., 2]
            if self.dense[level]:
                rows = gather_rows(self.packed_table(table_l, level),
                                   self._corner_index(level, x0))
                feats = rows.reshape(*rows.shape[:-1], 8, F)
            else:
                idx = self._corner_index(level, x0[..., None, :] + corners)
                feats = gather_rows(table_l, idx)                # [..., 8, F]
            outs.append((feats * weight[..., None]).sum(-2))
        return torch.cat(outs, dim=-1)


class MLPTexture3D:
    """Hash-grid encoder + ReLU MLP without bias, sigmoid into [min, max]."""

    def __init__(self, cfg, min_max: Tuple, device="cuda"):
        self.cfg = cfg
        self.encoder = HashGridEncoding(
            n_levels=cfg.n_levels, n_features=cfg.n_features_per_level,
            log2_hashmap_size=cfg.log2_hashmap_size,
            base_resolution=cfg.base_resolution,
            desired_resolution=cfg.desired_resolution,
            ref_levels_for_scale=cfg.ref_levels_for_scale)
        self.channels = cfg.channels
        self.internal_dims = cfg.internal_dims
        self.hidden = cfg.hidden
        self.gradient_scaling = cfg.gradient_scaling

        def t(a):
            return torch.tensor(a, dtype=torch.float32).to(device)

        self.min_max = (t(min_max[0]), t(min_max[1]))
        self.bbox_lo, self.bbox_hi = t(cfg.bbox_lo), t(cfg.bbox_hi)

    def init(self, gen: torch.Generator) -> Params:
        """Tables U(-1e-4, 1e-4); MLP kaiming-uniform (ReLU gain), no bias."""
        dev = self.bbox_lo.device
        dims = ([self.encoder.out_dim] + [self.internal_dims] * self.hidden
                + [self.channels])
        net = []
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            bound = math.sqrt(6.0 / d_in)
            net.append({"w": ((torch.rand((d_in, d_out), generator=gen, device=gen.device) * 2.0
                               - 1.0) * bound).to(dev)})
        return {"encoder": self.encoder.init(gen, dev), "net": net}

    def sample(self, params: Params, texc: torch.Tensor) -> torch.Tensor:
        """texc [..., 3] world-space points -> [..., channels] material."""
        lo, hi = self.bbox_lo, self.bbox_hi
        u = ((texc - lo) / (hi - lo)).clamp(0.0, 1.0)
        h = grad_scale(self.encoder.apply(params["encoder"], u),
                       self.gradient_scaling)
        for layer in params["net"][:-1]:
            h = torch.relu(h @ layer["w"])
        h = h @ params["net"][-1]["w"]
        mn, mx = self.min_max
        return torch.sigmoid(h) * (mx - mn) + mn
