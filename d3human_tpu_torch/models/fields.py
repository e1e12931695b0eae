"""Neural fields: positional encoding + the Softplus(beta=100) skip MLP,
and the pose-conditioned nonrigid ``DeformMLP``.

Counterpart of ``d3human_tpu/models/fields.py``. Parameters are a plain
dict ``{"layers": [{"w": [d_in, d_out], "b": [d_out]}, ...]}`` in the JAX
package's layout (``x @ w + b``), so converted JAX weights compute the same
function. With ``use_bfloat16`` the input and hidden layers multiply
bfloat16-rounded inputs and weights with float32 accumulation and a
float32 bias; the output layer stays float32 (the SDF's sign decides the
mesh's topology). At float32 points that do not require grad (the fits,
the nonrigid field at a template, every query under ``no_grad``) or whose
graph is differentiated once (the init and split grid queries, whose
points carry ``deform``'s gradient) each input and hidden layer is one
product with the bias and activation in its epilogue, forward and input
gradient (``ops/linear_softplus.py``); otherwise (the eikonal's input
gradient and its double backward, ``use_bfloat16``) its bias and
activation are one pass forward and one backward
(``ops/bias_softplus.py``) on the product without its bias.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from d3human_tpu_torch.ops import cuda_lib, linear_softplus
from d3human_tpu_torch.ops.bias_softplus import bias_softplus100
from d3human_tpu_torch.utils.consts import const
from d3human_tpu_torch.utils.logging import span

Params = dict


def posenc(x: torch.Tensor, n_freq: int) -> torch.Tensor:
    """(x, sin(2^k x), cos(2^k x), ...) for k in [0, n_freq): channels
    C * (2 * n_freq + 1), in the JAX package's interleaving."""
    if n_freq == 0:
        return x
    freqs = const(tuple(2.0 ** k for k in range(n_freq)), x.device, x.dtype)
    xb = x[..., None, :] * freqs[:, None]                  # [..., n_freq, C]
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], 2 * n_freq * x.shape[-1])
    return torch.cat([x, enc], dim=-1)


def posenc_dim(in_channels: int, n_freq: int) -> int:
    return in_channels * (2 * n_freq + 1)


def _linear_init(gen: torch.Generator, d_in: int, d_out: int,
                 device) -> Params:
    """PyTorch nn.Linear default init U(-1/sqrt(d_in), 1/sqrt(d_in))."""
    bound = 1.0 / math.sqrt(d_in)

    def u(*shape):
        return ((torch.rand(shape, generator=gen) * 2.0 - 1.0)
                * bound).to(device)

    return {"w": u(d_in, d_out), "b": u(d_out)}


class _Bf16Product(torch.autograd.Function):
    """x @ w of bfloat16 x [N, K] and w [K, M], accumulated and returned in
    float32 (``jnp.dot(..., preferred_element_type=float32)``): on the card
    a bfloat16 GEMM with float32 output; on the CPU the float32 product of
    the same operands, in which each product of two bfloat16 values is
    exact. The gradients of x and w are float32 products rounded to
    bfloat16, as the transpose of JAX's product gives them."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return torch.mm(x, w, out_dtype=torch.float32)
        return x.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (g @ w.float().t()).to(torch.bfloat16)
        if ctx.needs_input_grad[1]:
            gw = (x.float().t() @ g).to(torch.bfloat16)
        return gx, gw


def _product(lin: Params, h: torch.Tensor, bf16: bool) -> torch.Tensor:
    """h @ w, without the bias."""
    if not bf16:
        return h @ lin["w"]
    y = _Bf16Product.apply(h.reshape(-1, h.shape[-1]).to(torch.bfloat16),
                           lin["w"].to(torch.bfloat16))
    return y.reshape(*h.shape[:-1], y.shape[-1])


class MLP:
    """Softplus MLP over positional-encoded 3-D points: input layer,
    ``n_hidden`` hidden layers (layer i takes [h, PE] when i in skip_in),
    output layer, no output activation. ``d_extra_in`` channels (a pose
    code) precede the encoding at the input layer only: the skip layers
    concatenate the encoding alone."""

    def __init__(self, n_freq=6, d_hidden=256, d_out=1, n_hidden=6,
                 skip_in: Sequence[int] = (3,), use_bfloat16: bool = False,
                 d_extra_in: int = 0):
        self.n_freq = n_freq
        self.d_hidden = d_hidden
        self.d_out = d_out
        self.n_hidden = n_hidden
        self.skip_in = tuple(skip_in)
        self.use_bfloat16 = use_bfloat16
        self.d_extra_in = d_extra_in
        self.d_emb = posenc_dim(3, n_freq)

    def init(self, gen: torch.Generator, device="cuda") -> Params:
        layers = [_linear_init(gen, self.d_emb + self.d_extra_in,
                               self.d_hidden, device)]
        for i in range(self.n_hidden):
            d_in = self.d_hidden + (self.d_emb if i in self.skip_in else 0)
            layers.append(_linear_init(gen, d_in, self.d_hidden, device))
        layers.append(_linear_init(gen, self.d_hidden, self.d_out, device))
        return {"layers": layers}

    def apply(self, params: Params, x: torch.Tensor,
              extra: Optional[torch.Tensor] = None,
              checkpointed: bool = False,
              differentiated_once: bool = False) -> torch.Tensor:
        """The MLP at x [..., 3] (``extra`` [..., d_extra_in] before the
        encoding); ``checkpointed``: the call runs inside an activation
        checkpoint; ``differentiated_once``: the caller never
        differentiates the output's gradient again, so points that require
        grad may take the fused path (``linear_softplus.fusable``)."""
        with span("d3h.fields.mlp"):
            emb = posenc(x, self.n_freq)
            h = emb if extra is None else torch.cat([extra, emb], dim=-1)
            layers = params["layers"]
            # the input layer and the hidden layers; the output of layer j
            # feeds hidden layer j, so j in skip_in writes [h, emb]
            skips = [j for j in self.skip_in if j < self.n_hidden]
            if linear_softplus.fusable(x, self.use_bfloat16, self.d_hidden,
                                       checkpointed, differentiated_once):
                rows = x.shape[:-1]
                y = linear_softplus.fused_mlp(
                    layers, h.reshape(-1, h.shape[-1]),
                    emb.reshape(-1, emb.shape[-1]), skips)
                return y.reshape(*rows, y.shape[-1])
            cuda_lib.count_path("mlp_fallback", len(layers) - 1)
            for j, lin in enumerate(layers[:-1]):
                tail = emb if j in skips else None
                h = bias_softplus100(
                    _product(lin, h, self.use_bfloat16), lin["b"], tail)
            return h @ layers[-1]["w"] + layers[-1]["b"]


class DeformMLP(MLP):
    """Pose-conditioned offset field: [pose code, PE(x)] -> MLP -> d_out,
    the code broadcast over the points."""

    def __init__(self, n_freq=8, d_hidden=256, d_out=3, n_hidden=6,
                 skip_in: Sequence[int] = (3,), pose_dim=136,
                 use_bfloat16: bool = False):
        super().__init__(n_freq=n_freq, d_hidden=d_hidden, d_out=d_out,
                         n_hidden=n_hidden, skip_in=skip_in,
                         use_bfloat16=use_bfloat16, d_extra_in=pose_dim)
        self.pose_dim = pose_dim

    def apply(self, params: Params, x: torch.Tensor,
              pose_code: torch.Tensor) -> torch.Tensor:
        code = pose_code.reshape(self.pose_dim).expand(
            *x.shape[:-1], self.pose_dim)
        return super().apply(params, x, extra=code)


def sdf_gradient(mlp: MLP, params: Params, pts: torch.Tensor) -> torch.Tensor:
    """The field's input gradient at pts [..., 3], with its graph
    (``create_graph``), so a loss on it differentiates into the weights and
    into ``pts`` where they take gradients (the eikonal loss's double
    backward)."""
    with torch.enable_grad():
        x = pts if pts.requires_grad else pts.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(mlp.apply(params, x).sum(), x,
                                   create_graph=True)
    return g
