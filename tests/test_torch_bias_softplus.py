"""The fields MLP's fused bias + Softplus(beta=100) (``ops/bias_softplus.py``)
against the composition it replaces, ``softplus(100 (h @ w + b)) * 0.01``
through PyTorch's autograd, on the CPU (the Function's plain versions):
the forward bit for bit, the gradients within 1e-6 and the eikonal-style
double backward within 1e-5 (relative to the largest entry)."""

import pytest
import torch
import torch.nn.functional as F

from d3human_tpu_torch.models.fields import MLP, posenc, sdf_gradient
from d3human_tpu_torch.ops.bias_softplus import (
    bias_softplus100, bias_softplus100_grad_plain, bias_softplus100_plain,
)


def _composition(z, b, tail=None):
    h = F.softplus(100.0 * (z + b)) * 0.01
    return h if tail is None else torch.cat([h, tail], dim=-1)


def _rel(got, want):
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max() / want.abs().max())


def _composition_mlp(mlp, params, x):
    """``MLP.apply`` as it was built before the fused pass: bias, activation
    and skip concatenation as separate PyTorch operations."""
    emb = posenc(x, mlp.n_freq)
    h, lay = emb, params["layers"]
    h = _composition(h @ lay[0]["w"], lay[0]["b"])
    for i in range(mlp.n_hidden):
        if i in mlp.skip_in:
            h = torch.cat([h, emb], dim=-1)
        h = _composition(h @ lay[i + 1]["w"], lay[i + 1]["b"])
    return h @ lay[-1]["w"] + lay[-1]["b"]


def _layer(n=517, k=40, c=48, t=0, seed=0):
    """Inputs of one hidden layer: h [n, k], w [k, c], b [c] (sized so that
    100 (z + b) spans both sides of the threshold 20 and far below 0) and
    a tail [n, t]."""
    g = torch.Generator().manual_seed(seed)
    h = torch.rand((n, k), generator=g) * 2.0 - 1.0
    w = (torch.rand((k, c), generator=g) * 2.0 - 1.0) * 0.15
    b = (torch.rand((c,), generator=g) * 2.0 - 1.0) * 0.3
    tail = torch.randn((n, t), generator=g) if t else None
    return h, w, b, tail


@pytest.mark.parametrize("t", [0, 39])
def test_forward_bitwise_and_gradients(t):
    h, w, b, tail = _layer(t=t)
    z = h @ w
    u = 100.0 * (z + b)
    assert float(u.max()) > 20.0 and float(u.min()) < -20.0
    assert torch.equal(bias_softplus100(z, b, tail), _composition(z, b, tail))
    assert torch.equal(bias_softplus100_plain(z, b, tail),
                       _composition(z, b, tail))

    g = torch.Generator().manual_seed(1)
    g_out = torch.randn((h.shape[0], w.shape[1] + t), generator=g)
    grads = []
    for fn in (bias_softplus100, _composition):
        leaves = [x.clone().requires_grad_(True)
                  for x in (z, b) + (() if tail is None else (tail,))]
        out = fn(*leaves)
        grads.append(torch.autograd.grad(out, leaves, g_out))
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-6


def test_strided_gradient_equals_contiguous():
    """g_h as the first C columns of a wider gradient (the skip layer's
    product input gradient) gives what its contiguous copy gives."""
    h, w, b, _ = _layer()
    out = bias_softplus100_plain(h @ w, b)
    wide = torch.randn((h.shape[0], w.shape[1] + 39),
                       generator=torch.Generator().manual_seed(2))
    g_h = wide[:, :w.shape[1]]
    assert not g_h.is_contiguous()
    a = bias_softplus100_grad_plain(g_h, out)
    b_ = bias_softplus100_grad_plain(g_h.contiguous(), out)
    assert torch.equal(a[0], b_[0]) and torch.equal(a[1], b_[1])


@pytest.mark.parametrize("skip_in", [(1,), (0, 2)])
def test_double_backward_matches_composition(skip_in):
    """An MLP's input gradient with its graph, then a loss on it (as
    ``eikonal_loss``): its gradients into every leaf and into the points,
    against the same MLP built from the plain composition, within 1e-5."""
    mlp = MLP(n_freq=4, d_hidden=32, n_hidden=3, skip_in=skip_in)
    params = mlp.init(torch.Generator().manual_seed(3), "cpu")
    pts = torch.rand((300, 3), generator=torch.Generator().manual_seed(4))
    pts = (pts * 1.6 - 0.8).requires_grad_(True)
    results = []
    for fn in (mlp.apply, lambda p, x: _composition_mlp(mlp, p, x)):
        leaves = [t.clone().requires_grad_(True)
                  for lay in params["layers"] for t in (lay["w"], lay["b"])]
        p = {"layers": [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
                        for i in range(len(leaves) // 2)]}
        y = fn(p, pts)
        (grad,) = torch.autograd.grad(y.sum(), pts, create_graph=True)
        loss = ((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2).mean()
        ws = torch.autograd.grad(loss, leaves + [pts], allow_unused=True)
        results.append((y, grad, ws))
    (y, grad, ws), (y0, grad0, ws0) = results
    assert torch.equal(y, y0)
    assert _rel(grad, grad0) <= 1e-5
    for got, want in zip(ws, ws0):
        if want is None:
            assert got is None or not got.any()
            continue
        assert _rel(got, want) <= 1e-5


def test_sdf_gradient_through_mlp_matches_composition():
    """``sdf_gradient`` on the fused MLP at a skip layer equals the plain
    composition's input gradient within 1e-6 (its first backward)."""
    mlp = MLP(n_freq=6, d_hidden=64, n_hidden=4, skip_in=(2,))
    params = mlp.init(torch.Generator().manual_seed(5), "cpu")
    pts = torch.rand((200, 3), generator=torch.Generator().manual_seed(6))
    got = sdf_gradient(mlp, params, pts)
    x = pts.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(_composition_mlp(mlp, params, x).sum(), x)
    assert _rel(got, want) <= 1e-6


def test_leading_dims_and_no_grad():
    """[B, N, C] products (a batch of point sets) and a forward under
    no_grad give the 2-D results."""
    h, w, b, tail = _layer(n=60, t=7)
    z = (h @ w).reshape(3, 20, -1)
    with torch.no_grad():
        got = bias_softplus100(z, b, tail.reshape(3, 20, -1))
    assert got.shape == (3, 20, w.shape[1] + 7)
    assert torch.equal(got.reshape(60, -1), _composition(h @ w, b, tail))


def test_cuda_launch_count_untouched_on_cpu():
    before = (bias_softplus100.launches, bias_softplus100.calls)
    h, w, b, _ = _layer(n=10)
    z = (h @ w).requires_grad_(True)
    bias_softplus100(z, b).sum().backward()
    assert (bias_softplus100.launches, bias_softplus100.calls) == before
