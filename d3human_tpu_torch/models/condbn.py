"""Conditional-BatchNorm decoder (counterpart of
``d3human_tpu/models/condbn.py``): a latent-conditioned ResNet decoder in
which per-point codes modulate normalised features with a conditional
affine (gamma and beta from linear maps of the code, zero-initialised so
each block starts as a plain normalisation and the residual as the
identity). The statistics are those of the current call, over batch and
points per feature.

Parameters are ``{"w": [d_in, d_out], "b": [d_out]}`` linears in the JAX
package's layout (``convert.tree_from_jax`` carries its trees); ``init``
draws the port's own weights from a ``torch.Generator``."""

from __future__ import annotations

import torch

Params = dict


def _linear_init(gen, d_in: int, d_out: int, zero: bool = False,
                 device="cuda") -> dict:
    if zero:
        w = torch.zeros((d_in, d_out))
    else:
        bound = (1.0 / d_in) ** 0.5
        w = (torch.rand((d_in, d_out), generator=gen) * 2.0 - 1.0) * bound
    return {"w": w.to(device), "b": torch.zeros((d_out,), device=device)}


class CondBNDecoder:
    """apply(params, coords [B, N, Pin], codes [B, D] or [B, N, D]) ->
    [B, N, out]."""

    def __init__(self, input_dim: int = 3, latent_dim: int = 64,
                 hidden_dim: int = 128, num_hidden_layers: int = 4,
                 out_dim: int = 3):
        self.input_dim = input_dim
        self.latent_dim = latent_dim
        self.hidden_dim = hidden_dim
        self.num_blocks = num_hidden_layers
        self.out_dim = out_dim

    def _cbn_init(self, device) -> dict:
        # gamma: zero weight, bias one; beta: zero weight and bias
        z = torch.zeros((self.latent_dim, self.hidden_dim), device=device)
        return {"gamma": {"w": z.clone(),
                          "b": torch.ones((self.hidden_dim,), device=device)},
                "beta": {"w": z.clone(),
                         "b": torch.zeros((self.hidden_dim,),
                                          device=device)}}

    def init(self, gen: torch.Generator, device="cuda") -> Params:
        hd = self.hidden_dim
        return {
            "fc_p": _linear_init(gen, self.input_dim, hd, device=device),
            "blocks": [{
                "bn0": self._cbn_init(device),
                "bn1": self._cbn_init(device),
                "fc0": _linear_init(gen, hd, hd, device=device),
                "fc1": _linear_init(gen, hd, hd, zero=True, device=device),
            } for _ in range(self.num_blocks)],
            "bn": self._cbn_init(device),
            "fc_out": _linear_init(gen, hd, self.out_dim, device=device),
        }

    @staticmethod
    def _lin(p, x):
        return x @ p["w"] + p["b"]

    def _cbn(self, p, x, c, eps: float = 1e-5):
        mean = x.mean(dim=(0, 1), keepdim=True)
        var = x.var(dim=(0, 1), keepdim=True, unbiased=False)
        net = (x - mean) * torch.rsqrt(var + eps)
        return self._lin(p["gamma"], c) * net + self._lin(p["beta"], c)

    def apply(self, params: Params, coords: torch.Tensor,
              codes: torch.Tensor) -> torch.Tensor:
        if codes.dim() == 2:
            codes = codes[:, None, :].expand(*coords.shape[:2],
                                             codes.shape[-1])
        net = self._lin(params["fc_p"], coords)
        for blk in params["blocks"]:
            h = self._lin(blk["fc0"],
                          torch.relu(self._cbn(blk["bn0"], net, codes)))
            dx = self._lin(blk["fc1"],
                           torch.relu(self._cbn(blk["bn1"], h, codes)))
            net = net + dx
        return self._lin(params["fc_out"],
                         self._cbn(params["bn"], net, codes))
