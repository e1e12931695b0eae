"""Bias + Softplus(beta=100) of the fields MLP's hidden layers, forward and
backward in one pass each.

``bias_softplus100(z, b, tail)`` is ``softplus(100 (z + b)) / 100`` of a
layer's product z [..., C] (``models/fields.py``), with ``tail`` [..., T]
(the positional encoding, before a skip layer) written beside it as
``[h, tail]`` [..., C + T], the next product's input. A port-only kernel:
the JAX package's MLP is plain ``jnp``, which XLA fuses; in PyTorch the
chain ``+ b``, ``x100``, softplus, ``x0.01`` is four passes over the
activations forward and about seven backward, and softplus keeps its input
for the backward. On a CUDA tensor the forward is one launch of
``csrc/softplus100.cu`` and the backward two (g_z with per-block column
sums, then the sums' fixed-order reduce); on a CPU tensor the plain
versions below do the same arithmetic.

The Function saves only its output: the backward's sigmoid(100 (z + b)) =
1 - exp(-softplus(100 (z + b))) = -expm1(-100 h). The backward is itself
a Function whose backward is the closed form in plain PyTorch, so the
eikonal loss's double backward (``create_graph``) differentiates it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from d3human_tpu_torch.ops import cuda_lib

_PTR = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIG = {"d3h_bias_softplus100": (_PTR, _PTR, _PTR, _LL, ctypes.c_int, _PTR,
                                 _LL, _LL, ctypes.c_int, _PTR),
        "d3h_bias_softplus100_backward": (_PTR, _LL, _PTR, _LL, _PTR, _PTR,
                                          _PTR, _LL, ctypes.c_int, _PTR)}
ROWS = 256              # rows per CTA (csrc/softplus100.cu ROWS)
LAUNCHES = 1            # kernel launches per forward call
GRAD_LAUNCHES = 2       # per backward call: g_z and partial sums, reduce


def bias_softplus100_plain(z: torch.Tensor, b: torch.Tensor,
                           tail: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of the forward: ``softplus(100 (z + b)) *
    0.01``, then ``[h, tail]``."""
    h = F.softplus(100.0 * (z + b)) * 0.01
    return h if tail is None else torch.cat([h, tail], dim=-1)


def bias_softplus100_grad_plain(g: torch.Tensor, h: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: (g_z, g_b) of the gradient
    g of h, g_z = g * -expm1(-100 h) and g_b its column sums (in double,
    as the kernel adds)."""
    gz = g * -torch.expm1(-100.0 * h)
    gb = gz.reshape(-1, gz.shape[-1]).sum(0, dtype=torch.float64)
    return gz, gb.to(gz.dtype)


def _check_cuda(what: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32 or t.device != ts[0].device:
            raise ValueError(f"bias_softplus100 {what}: float32 tensors on "
                             f"one device only, got {t.dtype} on {t.device}"
                             f" beside {ts[0].device}")


def _forward_cuda(z: torch.Tensor, b: torch.Tensor,
                  tail: Optional[torch.Tensor]) -> torch.Tensor:
    _check_cuda("forward", z, b, *(() if tail is None else (tail,)))
    c = z.shape[-1]
    t = 0 if tail is None else tail.shape[-1]
    if b.shape != (c,):
        raise ValueError(f"bias_softplus100: bias {tuple(b.shape)} for "
                         f"{c} columns")
    z2 = z.reshape(-1, c).contiguous()
    n = z2.shape[0]
    out = torch.empty((*z.shape[:-1], c + t), dtype=torch.float32,
                      device=z.device)
    tail2 = None
    if tail is not None:
        if tail.shape[:-1] != z.shape[:-1]:
            raise ValueError(f"bias_softplus100: tail {tuple(tail.shape)} "
                             f"for rows {tuple(z.shape[:-1])}")
        tail2 = tail.reshape(-1, t)
        if tail2.stride(-1) != 1:
            tail2 = tail2.contiguous()
    bias_softplus100.calls += 1
    if n == 0:
        return out
    b = b.contiguous()
    cuda_lib.launch(bias_softplus100, "d3h_bias_softplus100", z2.data_ptr(),
                    b.data_ptr(), None if tail2 is None else tail2.data_ptr(),
                    0 if tail2 is None else tail2.stride(0), t,
                    out.data_ptr(), c + t, n, c, device=z.device,
                    launches=LAUNCHES)
    return out


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x [..., C] as a 2-D [rows, C] view with unit column stride (copied
    only where no such view exists)."""
    x2 = x.reshape(-1, x.shape[-1])
    return x2 if x2.stride(-1) == 1 else x2.contiguous()


def _backward_cuda(g: torch.Tensor, h: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_cuda("backward", g, h)
    c = h.shape[-1]
    g2, h2 = _rows(g), _rows(h)
    n = h2.shape[0]
    gz = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    if n == 0:
        return gz, torch.zeros((c,), dtype=torch.float32, device=h.device)
    gb = torch.empty((c,), dtype=torch.float32, device=h.device)
    partial = torch.empty((c * -(-n // ROWS),), dtype=torch.float64,
                          device=h.device)
    cuda_lib.launch(bias_softplus100, "d3h_bias_softplus100_backward",
                    g2.data_ptr(), g2.stride(0), h2.data_ptr(), h2.stride(0),
                    gz.data_ptr(), partial.data_ptr(), gb.data_ptr(), n, c,
                    device=h.device, launches=GRAD_LAUNCHES)
    return gz, gb


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"bias_softplus100: unsupported device {x.device}")
    return True


class _BiasSoftplus100Grad(torch.autograd.Function):
    """(g, h) -> (g_z, g_b): the backward of ``_BiasSoftplus100`` as a
    Function of its own, differentiable in closed form. With s =
    -expm1(-100 h), g_z = g s and g_b = sum_rows g_z, so an incoming
    (gg_z, gg_b) gives d/dg = G s and d/dh = G g 100 exp(-100 h), G =
    gg_z + gg_b broadcast over the rows."""

    @staticmethod
    def forward(ctx, g, h):
        ctx.save_for_backward(g, h)
        if _on_cuda(h):
            return _backward_cuda(g, h)
        return bias_softplus100_grad_plain(g, h)

    @staticmethod
    def backward(ctx, gg_z, gg_b):
        g, h = ctx.saved_tensors
        G = gg_z + gg_b
        d_g = G * -torch.expm1(-100.0 * h) if ctx.needs_input_grad[0] \
            else None
        d_h = G * g * (100.0 * torch.exp(-100.0 * h)) \
            if ctx.needs_input_grad[1] else None
        return d_g, d_h


class _BiasSoftplus100(torch.autograd.Function):
    """(z, b, tail) -> ``[softplus(100 (z + b)) / 100, tail]``; saves only
    its output."""

    @staticmethod
    def forward(ctx, z, b, tail):
        ctx.c = z.shape[-1]
        ctx.has_tail = tail is not None
        out = (_forward_cuda(z, b, tail) if _on_cuda(z)
               else bias_softplus100_plain(z, b, tail))
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g_out):
        (out,) = ctx.saved_tensors
        c = ctx.c
        g_z = g_b = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            g_z, g_b = _BiasSoftplus100Grad.apply(g_out[..., :c],
                                                  out[..., :c])
        g_tail = g_out[..., c:] if ctx.has_tail else None
        return g_z, g_b, g_tail


@cuda_lib.counted("softplus100", _SIG)
def bias_softplus100(z: torch.Tensor, b: torch.Tensor,
                     tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``softplus(100 (z + b)) / 100`` of z [..., C] and the bias b [C],
    or ``[that, tail]`` [..., C + T] with tail [..., T]; differentiable
    twice. float32 on a CUDA device (the kernel), any float type on the
    CPU (the plain versions)."""
    return _BiasSoftplus100.apply(z, b, tail)
