"""The fields MLP's input and hidden layers as one f32 GEMM each with the
bias + Softplus(beta=100) in its epilogue, forward and input gradient.

``fused_mlp(layers, h0, tail, skips)`` is ``models/fields.py``'s MLP from
its first layer's input h0 [N, K0] (the positional encoding, or a code and
the encoding): layer j computes ``softplus(100 (x @ w + b)) / 100`` of its
input x, and a layer j in ``skips`` writes ``[h, tail]`` (the encoding), the
next layer's input; the output layer is ``h @ w + b``. On a CUDA tensor
each input and hidden layer's forward is one launch of
``csrc/linear_softplus.cu`` (the product never reaches device memory, only
h does), and the backward runs, for each layer from the top, the product
of the incoming pre-activation gradient g_z with the layer's weights with
the lower layer's softplus derivative ``-expm1(-100 h)`` and its bias
column sums in the epilogue (two launches: the product, then the sums'
fixed-order reduce); the weight gradients ``x^T @ g_z`` are
``torch.matmul``. On a CPU tensor the plain versions below do the same
arithmetic with ``torch.matmul`` and ``ops/bias_softplus.py``'s plain
functions.

A port-only kernel, after ``ops/bias_softplus.py`` (which stays for what
this one does not take): the JAX package's MLP is plain ``jnp``.

The Function saves what the other path saves, each layer's input (the h's).
Its inputs (h0 and the weights) go through ``save_for_backward``, so an
in-place change to one before the backward raises, as on the other path;
the activations it makes itself are kept on the Function and freed each
as soon as the backward has used it. Saved-tensor hooks do not see those,
so inside an activation checkpoint the MLP takes the other path wherever
grad is on. The backward gives h0's gradient and the encoding's (``tail``,
the skip layers' share: the encoding's columns of their input gradients,
before any softplus derivative), but it is not differentiable again: a
backward that builds a graph (``create_graph``) raises, rather than give
a gradient without one, which would read as zero. So the MLP
takes this path for a point input that does not require grad, or whose
graph its caller differentiates once (``fusable``): the fit, the nonrigid
field at the template, every query under ``no_grad``, and the init and
split grid queries, whose points carry ``deform``'s gradient. The
eikonal's input gradient and its double backward, and ``use_bfloat16``,
keep the other path: a product, then ``ops/bias_softplus.py``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from d3human_tpu_torch.ops import cuda_lib
from d3human_tpu_torch.ops.bias_softplus import (
    bias_softplus100_grad_plain, bias_softplus100_plain,
)

_PTR = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int
_SIG = {"d3h_linear_softplus100": (_PTR, _LL, _INT, _PTR, _PTR, _INT, _PTR,
                                   _LL, _INT, _PTR, _LL, _LL, _PTR),
        "d3h_linear_softplus100_dx": (_PTR, _LL, _INT, _PTR, _PTR, _LL,
                                      _PTR, _LL, _INT, _PTR, _PTR, _PTR)}
TILE_ROWS = 128         # rows of a CTA's tile (csrc/linear_softplus.cu BM)
LAUNCHES = 1            # kernel launches per forward layer
GRAD_LAUNCHES = 2       # per input-gradient layer: product, bias reduce


def fusable(x: torch.Tensor, use_bfloat16: bool, d_hidden: int,
            checkpointed: bool = False,
            differentiated_once: bool = False) -> bool:
    """Whether the MLP at points x takes the fused path: float32 points
    that do not require grad or whose graph the caller differentiates once
    (``differentiated_once``), float32 products (not ``use_bfloat16``) and
    hidden rows of whole float4s; inside an activation checkpoint
    (``checkpointed``) only with grad off, since the checkpoint's hooks
    cannot drop the activations the fused path keeps."""
    return (not use_bfloat16 and x.dtype == torch.float32
            and (differentiated_once or not x.requires_grad)
            and d_hidden % 4 == 0
            and not (checkpointed and torch.is_grad_enabled()))


def _padded(m: int, c: int, like: torch.Tensor) -> torch.Tensor:
    """[m, c] with a row stride of c rounded up to 4 floats."""
    return torch.empty((m, -(-c // 4) * 4), dtype=torch.float32,
                       device=like.device)[:, :c]


def linear_softplus100_plain(x: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor,
                             tail: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of the forward: ``[softplus(100 (x @ w + b))
    * 0.01, tail]`` of x [M, K], in a [M, C + T] view of rows padded to 4
    floats."""
    c, t = w.shape[1], 0 if tail is None else tail.shape[1]
    out = _padded(x.shape[0], c + t, x)
    out[:, :c] = bias_softplus100_plain(x @ w, b)
    if tail is not None:
        out[:, c:] = tail
    return out


def linear_softplus100_dx_plain(g: torch.Tensor, w: torch.Tensor,
                                h: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the input gradient: (g_z', g_b') with g_z'
    = ``(g @ w^T)[:, :C] * -expm1(-100 h)`` of g [M, Kd], w [K, Kd] and
    h [M, C], and g_b' its column sums (in double)."""
    return bias_softplus100_grad_plain((g @ w.t())[:, :h.shape[1]], h)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def _check(what: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32 or t.device != ts[0].device \
                or t.dim() != 2:
            raise ValueError(f"linear_softplus100 {what}: 2-D float32 "
                             f"tensors on one device only, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


@cuda_lib.counted("linear_softplus", _SIG)
def linear_softplus100(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[softplus(100 (x @ w + b)) / 100, tail]`` of x [M, K], w [K, C],
    b [C] and tail [M, T], as a [M, C + T] view of rows padded to 4 floats:
    one launch on a CUDA device, the plain version on the CPU. C is a
    multiple of 4; x may have any row stride."""
    _check("forward", x, w, b[None], *(() if tail is None else (tail,)))
    m, k = x.shape
    c, t = w.shape[1], 0 if tail is None else tail.shape[1]
    if w.shape[0] != k or b.shape != (c,) or c % 4 \
            or (tail is not None and tail.shape[0] != m):
        raise ValueError(f"linear_softplus100: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}, tail "
                         f"{None if tail is None else tuple(tail.shape)}")
    if x.device.type == "cpu":
        return linear_softplus100_plain(x, w, b, tail)
    if x.device.type != "cuda":
        raise ValueError(f"linear_softplus100: unsupported device {x.device}")
    linear_softplus100.calls += 1
    out = _padded(m, c + t, x)
    if m == 0:
        return out
    x = _rows(x)
    w, b = w.contiguous(), b.contiguous()
    tail = None if tail is None else _rows(tail)
    if not _aligned(w, b):
        raise ValueError("linear_softplus100: w and b must start on 16 bytes")
    cuda_lib.launch(linear_softplus100, "d3h_linear_softplus100",
                    x.data_ptr(), x.stride(0), k, w.data_ptr(), b.data_ptr(),
                    c, None if tail is None else tail.data_ptr(),
                    0 if tail is None else tail.stride(0), t, out.data_ptr(),
                    out.stride(0), m, device=x.device, launches=LAUNCHES)
    return out


def linear_softplus100_dx(g: torch.Tensor, w: torch.Tensor, h: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g_z', g_b'): ``(g @ w^T)[:, :C] * -expm1(-100 h)`` of g [M, Kd],
    w [K, Kd] (K >= C) and h [M, C] (the layer's input; on a CUDA device in
    rows that start on 16 bytes, as ``linear_softplus100`` writes them), a
    contiguous [M, C], and its column sums. Two launches on a CUDA device
    after a copy of ``w[:C]^T``, the plain version on the CPU. C is a
    multiple of 4."""
    _check("dx", g, w, h)
    m, c = h.shape
    if g.shape[0] != m or w.shape[1] != g.shape[1] or w.shape[0] < c \
            or c % 4:
        raise ValueError(f"linear_softplus100_dx: g {tuple(g.shape)}, w "
                         f"{tuple(w.shape)}, h {tuple(h.shape)}")
    if h.device.type == "cpu":
        return linear_softplus100_dx_plain(g, w, h)
    if h.device.type != "cuda":
        raise ValueError(f"linear_softplus100_dx: unsupported device "
                         f"{h.device}")
    gz = torch.empty((m, c), dtype=torch.float32, device=h.device)
    if m == 0:
        return gz, torch.zeros((c,), dtype=torch.float32, device=h.device)
    g = _rows(g)
    wt = w[:c].t().contiguous()
    if h.stride(-1) != 1 or h.stride(0) % 4 or not _aligned(h):
        raise ValueError("linear_softplus100_dx: h's rows must start on 16 "
                         f"bytes, got a row stride of {h.stride(0)}")
    gb = torch.empty((c,), dtype=torch.float32, device=h.device)
    partial = torch.empty((c * -(-m // TILE_ROWS),), dtype=torch.float64,
                          device=h.device)
    cuda_lib.launch(linear_softplus100, "d3h_linear_softplus100_dx",
                    g.data_ptr(), g.stride(0), g.shape[1], wt.data_ptr(),
                    h.data_ptr(), h.stride(0), gz.data_ptr(), m, c,
                    partial.data_ptr(), gb.data_ptr(), device=h.device,
                    launches=GRAD_LAUNCHES)
    return gz, gb


class _FusedMLP(torch.autograd.Function):
    """(h0, tail, w0, b0, ..., w_out, b_out) -> the MLP's output [N, D].
    Keeps each layer's input for the backward only where a gradient is
    wanted (``keep``): h0 and the weights as saved tensors, the
    activations on the Function, each freed once used."""

    @staticmethod
    def forward(ctx, skips, keep, h0, tail, *leaves):
        ctx.skips = skips
        ws, bs = leaves[0::2], leaves[1::2]
        xs = []
        h = h0
        for j in range(len(ws) - 1):
            h = linear_softplus100(h, ws[j], bs[j],
                                   tail if j in skips else None)
            if keep:
                xs.append(h)
        if keep:
            ctx.save_for_backward(h0, *ws)
        ctx.xs = xs
        return h @ ws[-1] + bs[-1]

    @staticmethod
    def backward(ctx, g_y):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "the fused fields MLP cannot differentiate twice: a graph "
                "whose gradient is differentiated again (create_graph) must "
                "take the unfused path (linear_softplus.fusable)")
        h0, *ws = ctx.saved_tensors
        xs = [h0, *ctx.xs]
        ctx.xs = None
        n = len(ws) - 1                     # input and hidden layers
        need_h0, need_tail = ctx.needs_input_grad[2:4]
        need = ctx.needs_input_grad[4:]
        grads = [None] * (2 * len(ws))
        g = _rows(g_y)
        h = xs.pop()                        # the last hidden layer's output
        if need[2 * n]:
            grads[2 * n] = h.t() @ g
        if need[2 * n + 1]:
            grads[2 * n + 1] = g.sum(0)
        # the lowest layer that a wanted gradient reaches
        low = -1 if need_h0 or need_tail else next(
            (j for j in range(n) if need[2 * j] or need[2 * j + 1]), n)
        g_h0 = g_tail = None
        for j in range(n, max(low, 0), -1):
            # g: the gradient of layer j's pre-activation (j = n: of the
            # output); h: layer j's input, the output of layer j - 1
            if need_tail and j - 1 in ctx.skips:
                # the encoding's columns of layer j's input gradient
                g_e = g @ ws[j][ws[j - 1].shape[1]:].t()
                g_tail = g_e if g_tail is None else g_tail + g_e
            g, grads[2 * (j - 1) + 1] = linear_softplus100_dx(
                g, ws[j], h[:, :ws[j - 1].shape[1]])
            h = xs.pop()                    # layer j - 1's input
            if need[2 * (j - 1)]:
                grads[2 * (j - 1)] = h.t() @ g
        if need_h0:
            g_h0 = g @ ws[0].t()
        return (None, None, g_h0, g_tail, *grads)


def fused_mlp(layers: Sequence[dict], h0: torch.Tensor,
              tail: torch.Tensor, skips: Sequence[int]) -> torch.Tensor:
    """The MLP of ``layers`` (``[{"w": [K, C], "b": [C]}, ...]``, the last
    the output layer) from its input h0 [N, K0]; input and hidden layer j
    in ``skips`` writes ``[h, tail]`` (tail [N, T]). Differentiable once
    in h0, tail and the layers."""
    leaves = [t for lay in layers for t in (lay["w"], lay["b"])]
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in [h0, tail, *leaves])
    cuda_lib.count_path("mlp_fused", len(layers) - 1)
    return _FusedMLP.apply(frozenset(skips), keep, h0, tail, *leaves)
