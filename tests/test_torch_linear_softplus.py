"""The fields MLP's products with the bias + Softplus(beta=100) in their
epilogue (``ops/linear_softplus.py``) against the path it replaces, a
product and then ``ops/bias_softplus.py``, on the CPU (the plain versions):
the forward, the weight, bias and input gradients, the skip layer's rows
padded to 4 floats, each pattern of wanted gradients, which path
``MLP.apply`` takes, points that carry a gradient in a graph
differentiated once (the init and split grid queries: the extraction and
one init and split tick on ``chip_smoke.py``'s tiny scene), and a 3-step
``pretrain_sdf``."""

import types

import pytest
import torch

from d3human_tpu_torch.models.fields import MLP, DeformMLP, posenc
from d3human_tpu_torch.models.geometry import GeometryModel
from d3human_tpu_torch.ops import cuda_lib
from d3human_tpu_torch.ops import linear_softplus as ls
from d3human_tpu_torch.ops.bias_softplus import (
    bias_softplus100, bias_softplus100_grad_plain,
)


def _paths(before=(0, 0)):
    """(fused, fallback): the MLP's input and hidden layers counted on each
    path (``cuda_lib.path_counts``), less ``before``."""
    n = cuda_lib.path_counts()
    return n["mlp_fused"] - before[0], n["mlp_fallback"] - before[1]


def _rel(got, want):
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max() / want.abs().max())


def _layer(n=517, k=40, c=48, t=0, seed=0):
    """Inputs of one layer: x [n, k], w [k, c], b [c] (100 (x @ w + b) on
    both sides of the softplus threshold 20 and far below 0), a tail
    [n, t]."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, k), generator=g) * 2.0 - 1.0
    w = (torch.rand((k, c), generator=g) * 2.0 - 1.0) * 0.15
    b = (torch.rand((c,), generator=g) * 2.0 - 1.0) * 0.3
    tail = torch.randn((n, t), generator=g) if t else None
    return x, w, b, tail


def _padded_view(x):
    """x as the first columns of rows padded to 4 floats, the pad NaN."""
    buf = torch.full((x.shape[0], -(-x.shape[1] // 4) * 4), float("nan"))
    buf[:, :x.shape[1]] = x
    return buf[:, :x.shape[1]]


@pytest.mark.parametrize("t", [0, 39])
@pytest.mark.parametrize("k", [39, 256, 295])
def test_forward_equals_product_then_bias_softplus(k, t):
    """The fused forward equals ``bias_softplus100(x @ w, b, tail)`` bit
    for bit, in rows padded to 4 floats; x in such rows (the skip layer's
    input) gives the same bits."""
    x, w, b, tail = _layer(k=k, c=256, t=t)
    u = 100.0 * (x @ w + b)
    assert float(u.max()) > 20.0 and float(u.min()) < -20.0
    got = ls.linear_softplus100(x, w, b, tail)
    assert got.shape == (x.shape[0], 256 + t)
    assert got.stride(0) == -(-(256 + t) // 4) * 4
    assert torch.equal(got, bias_softplus100(x @ w, b, tail))
    xp = _padded_view(x)
    assert torch.equal(ls.linear_softplus100(xp, w, b, tail), got)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("kd", [1, 48])
def test_dx_equals_product_then_bias_softplus_grad(kd, strided):
    """g_z' = (g @ w^T)[:, :C] * -expm1(-100 h) and its column sums equal
    the product followed by bias_softplus's plain backward, with h the first C
    columns of padded rows of 295 (the skip layer's input) or contiguous;
    kd 1 is the output layer's rank-1 gradient."""
    g = torch.Generator().manual_seed(kd)
    x, _, _, _ = _layer(k=295, seed=1)
    h = torch.rand((x.shape[0], 256), generator=g) * 0.05
    if strided:
        h = _padded_view(torch.cat([h, x[:, :39]], dim=-1))[:, :256]
        assert h.stride(0) == 296
    w = torch.randn((295 if kd > 1 else 256, kd), generator=g) * 0.1
    gz = torch.randn((x.shape[0], kd), generator=g)
    got = ls.linear_softplus100_dx(gz, w, h)
    want = bias_softplus100_grad_plain((gz @ w.t())[:, :256], h)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].is_contiguous()


def _mlp_pair(kind, skip_in=(3,), n=400):
    """An MLP at a small width and its points (not requiring grad)."""
    gen = torch.Generator().manual_seed(7)
    if kind == "deform":
        mlp = DeformMLP(n_freq=4, d_hidden=32, n_hidden=4, skip_in=skip_in,
                        pose_dim=10)
    else:
        mlp = MLP(n_freq=6, d_hidden=32, n_hidden=5, skip_in=skip_in)
    params = mlp.init(gen, "cpu")
    pts = torch.rand((n, 3), generator=gen) * 1.6 - 0.8
    return mlp, params, pts


def _previous_path(mlp, params, x, extra=None):
    """``MLP.apply``'s other path: each product, then
    ``bias_softplus100`` with the encoding beside the skip layers' h."""
    emb = posenc(x, mlp.n_freq)
    h = emb if extra is None else torch.cat([extra, emb], dim=-1)
    lay = params["layers"]
    for j, lin in enumerate(lay[:-1]):
        tail = emb if j < mlp.n_hidden and j in mlp.skip_in else None
        h = bias_softplus100(h @ lin["w"], lin["b"], tail)
    return h @ lay[-1]["w"] + lay[-1]["b"]


# which leaves require grad: all, the top two layers only, the biases only,
# none (a forward), and (DeformMLP) the pose code as well
PATTERNS = {"all": lambda i, name: True,
            "top": lambda i, name: i >= 5,
            "biases": lambda i, name: name == "b",
            "none": lambda i, name: False}


@pytest.mark.parametrize("skip_in", [(3,), (0, 2), ()])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_fused_mlp_equals_previous_path(pattern, skip_in):
    """The fused MLP's output and the gradients of the wanted leaves equal
    the product + ``bias_softplus100`` path; the others get none."""
    mlp, params, pts = _mlp_pair("sdf", skip_in)
    g_out = torch.randn((pts.shape[0], 1),
                        generator=torch.Generator().manual_seed(8))
    results = []
    for fn in (mlp.apply, lambda p, x: _previous_path(mlp, p, x)):
        leaves = [t.clone().requires_grad_(PATTERNS[pattern](i, name))
                  for i, lay in enumerate(params["layers"])
                  for name, t in sorted(lay.items())]
        p = {"layers": [{"b": leaves[2 * i], "w": leaves[2 * i + 1]}
                        for i in range(len(leaves) // 2)]}
        y = fn(p, pts)
        want = [t for t in leaves if t.requires_grad]
        grads = torch.autograd.grad(y, want, g_out) if want else ()
        results.append((y, grads))
    (y, grads), (y0, grads0) = results
    assert torch.equal(y, y0)
    assert len(grads) == len(grads0)
    for got, want in zip(grads, grads0):
        assert torch.equal(got, want)


def test_deform_mlp_with_pose_code_gradient():
    """DeformMLP at template points with a pose code that requires grad:
    the code's gradient goes through the first layer's input gradient,
    equal to the product + ``bias_softplus100`` path; the fused path taken."""
    mlp, params, pts = _mlp_pair("deform")
    code = torch.randn((1, 1, 10), generator=torch.Generator().manual_seed(9))
    results = []
    for fused in (True, False):
        c = code.clone().requires_grad_(True)
        leaves = [t.clone().requires_grad_(True)
                  for lay in params["layers"] for t in (lay["w"], lay["b"])]
        p = {"layers": [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
                        for i in range(len(leaves) // 2)]}
        before = _paths()
        if fused:
            y = mlp.apply(p, pts, c)
            assert _paths(before)[0] == mlp.n_hidden + 1
        else:
            y = _previous_path(mlp, p, pts, c.reshape(10).expand(
                pts.shape[0], 10))
        results.append((y, torch.autograd.grad((y * y).sum(),
                                               [c] + leaves)))
    (y, g), (y0, g0) = results
    assert torch.equal(y, y0)
    for got, want in zip(g, g0):
        assert _rel(got, want) <= 1e-6


def test_mlp_takes_the_fused_path_only_without_input_grad():
    """``MLP.apply`` counts its input and hidden layers on the fused path
    for points that do not require grad (also under no_grad and with
    leading dimensions), and on the product + ``bias_softplus100`` path for
    points that do (the
    eikonal's input gradient) unless the caller differentiates the graph
    once, and for ``use_bfloat16``."""
    mlp, params, pts = _mlp_pair("sdf")
    layers = mlp.n_hidden + 1

    def counts(fn):
        before = _paths()
        out = fn()
        return out, _paths(before)

    y, n = counts(lambda: mlp.apply(params, pts))
    assert n == (layers, 0)
    with torch.no_grad():
        y2, n = counts(lambda: mlp.apply(params, pts.reshape(20, 20, 3)))
    assert n == (layers, 0) and torch.equal(y2.reshape(-1, 1), y)
    x = pts.clone().requires_grad_(True)
    _, n = counts(lambda: torch.autograd.grad(
        mlp.apply(params, x).sum(), x, create_graph=True))
    assert n == (0, layers)
    bf = MLP(n_freq=6, d_hidden=32, n_hidden=5, skip_in=(3,),
             use_bfloat16=True)
    _, n = counts(lambda: bf.apply(params, pts))
    assert n == (0, layers)
    assert ls.fusable(pts, False, 32) and not ls.fusable(pts, False, 30)
    assert not ls.fusable(pts.double(), False, 32)
    assert not ls.fusable(x, False, 32)
    assert ls.fusable(x, False, 32, differentiated_once=True)
    assert not ls.fusable(x, True, 32, differentiated_once=True)
    assert not ls.fusable(x, False, 32, True, True)


def test_no_cuda_launch_on_cpu():
    mlp, params, pts = _mlp_pair("sdf")
    fn = ls.linear_softplus100
    before = (fn.launches, fn.calls)
    leaves = [t.requires_grad_(True) for lay in params["layers"]
              for t in lay.values()]
    mlp.apply(params, pts).sum().backward()
    assert all(t.grad is not None for t in leaves)
    assert (fn.launches, fn.calls) == before


def test_pretrain_sdf_three_steps_equals_previous_path(monkeypatch):
    """Three steps of ``GeometryModel.pretrain_sdf`` (full-batch Adam) on
    the fused path against the same steps on the product +
    ``bias_softplus100`` path: every leaf and
    the loss within f32 round-off; 7 layers fused a step."""
    mlp = MLP(n_freq=6, d_hidden=64, n_hidden=6, skip_in=(3,))
    gen = torch.Generator().manual_seed(10)
    params = {"sdf_net": mlp.init(gen, "cpu")}
    verts = torch.rand((3000, 3), generator=gen) - 0.5
    geo = types.SimpleNamespace(grid=types.SimpleNamespace(verts=verts),
                                sdf_mlp=mlp, _fit=GeometryModel._fit)
    target = 0.3 - verts.norm(dim=-1)
    before = _paths()
    fused, loss = GeometryModel.pretrain_sdf(geo, params, target, steps=3)
    assert _paths(before)[0] == 3 * (mlp.n_hidden + 1)
    monkeypatch.setattr(ls, "fusable", lambda *a: False)
    prev, loss0 = GeometryModel.pretrain_sdf(geo, params, target, steps=3)
    assert abs(loss - loss0) <= 1e-6 * abs(loss0)
    for a, b in zip(fused["sdf_net"]["layers"], prev["sdf_net"]["layers"]):
        for key in ("w", "b"):
            assert _rel(a[key], b[key]) <= 1e-6


@pytest.mark.parametrize("which", ["w", "b"])
def test_in_place_change_before_backward_raises(which):
    """A weight changed in place between the fused forward and its
    backward raises autograd's version error, as on the other path; a
    bias (which the backward does not read) changes nothing."""
    mlp, params, pts = _mlp_pair("sdf")
    leaves = [t.clone().requires_grad_(True)
              for lay in params["layers"] for t in (lay["w"], lay["b"])]
    p = {"layers": [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
                    for i in range(len(leaves) // 2)]}
    y = mlp.apply(p, pts)
    with torch.no_grad():
        p["layers"][2][which].mul_(1.5)
    if which == "w":
        with pytest.raises(RuntimeError, match="inplace operation"):
            y.sum().backward()
    else:
        y.sum().backward()
        assert all(t.grad is not None for t in leaves)


def test_checkpointed_query_takes_the_unfused_path_with_grad():
    """``GeometryModel.query_sdf`` in chunks (each under an activation
    checkpoint) takes the product + ``bias_softplus100`` path with grad on,
    so the checkpoint can drop and recompute its activations, and the
    fused path under ``no_grad``; the chunked output and gradients equal
    the unchunked fused query's within f32 round-off."""
    mlp, params, pts = _mlp_pair("sdf", n=730)
    geo = types.SimpleNamespace(cfg=types.SimpleNamespace(
        geometry=types.SimpleNamespace(sdf_chunk=0)), sdf_mlp=mlp)
    chunked = types.SimpleNamespace(cfg=types.SimpleNamespace(
        geometry=types.SimpleNamespace(sdf_chunk=100)), sdf_mlp=mlp)
    layers = mlp.n_hidden + 1
    results = []
    for model, paths in ((geo, (layers, 0)), (chunked, (0, 8 * 2 * layers))):
        net = {"layers": [{k: t.clone().requires_grad_(True)
                           for k, t in lay.items()}
                          for lay in params["layers"]]}
        before = _paths()
        out = GeometryModel.query_sdf(model, {"sdf_net": net}, pts)
        out.square().sum().backward()
        # the chunked forward runs each chunk again in the backward
        assert _paths(before) == paths
        results.append((out, [lay[k].grad for lay in net["layers"]
                              for k in ("w", "b")]))
    (y, g), (y0, g0) = results
    assert _rel(y0, y) <= 1e-6
    for got, want in zip(g0, g):
        assert _rel(got, want) <= 1e-5
    before = _paths()
    with torch.no_grad():
        out = GeometryModel.query_sdf(chunked, {"sdf_net": params}, pts)
    assert _paths(before) == (8 * layers, 0)
    assert torch.equal(out, y0.detach())
    assert ls.fusable(pts, False, 32, checkpointed=False)
    assert not ls.fusable(pts, False, 32, checkpointed=True)
    with torch.no_grad():
        assert ls.fusable(pts, False, 32, checkpointed=True)


def _once(mlp, p, x, extra=None):
    """``MLP.apply`` for a graph differentiated once (``extra``: the pose
    code, broadcast over the points)."""
    if extra is not None:
        extra = extra.reshape(-1).expand(*x.shape[:-1], extra.numel())
    return MLP.apply(mlp, p, x, extra=extra, differentiated_once=True)


@pytest.mark.parametrize("kind", ["sdf", "deform"])
@pytest.mark.parametrize("skip_in", [(3,), (0, 2), ()])
@pytest.mark.parametrize("pattern", ["all", "top", "none"])
def test_fused_mlp_at_points_with_grad_equals_previous_path(pattern, skip_in,
                                                            kind):
    """Points that require grad, in a graph differentiated once: the fused
    path (all its layers) gives the output and the gradients of the points,
    the wanted leaves and (DeformMLP) the pose code of the product +
    ``bias_softplus100`` path, the skip layers' share of the encoding's
    gradient included."""
    mlp, params, pts = _mlp_pair(kind, skip_in)
    code = torch.randn((1, 1, 10), generator=torch.Generator().manual_seed(9))
    g_out = torch.randn((pts.shape[0], mlp.d_out),
                        generator=torch.Generator().manual_seed(8))
    layers = mlp.n_hidden + 1
    results = []
    for fused in (True, False):
        x = pts.clone().requires_grad_(True)
        c = code.clone().requires_grad_(True) if kind == "deform" else None
        leaves = [t.clone().requires_grad_(PATTERNS[pattern](i, name))
                  for i, lay in enumerate(params["layers"])
                  for name, t in sorted(lay.items())]
        p = {"layers": [{"b": leaves[2 * i], "w": leaves[2 * i + 1]}
                        for i in range(len(leaves) // 2)]}
        before = _paths()
        if fused:
            y = _once(mlp, p, x, c)
            assert _paths(before) == (layers, 0)
        else:
            y = _previous_path(mlp, p, x, None if c is None else
                               c.reshape(10).expand(pts.shape[0], 10))
        want = [x] + ([c] if c is not None else []) + [
            t for t in leaves if t.requires_grad]
        results.append((y, torch.autograd.grad(y, want, g_out)))
    (y, grads), (y0, grads0) = results
    assert torch.equal(y, y0)
    assert len(grads) == len(grads0)
    for got, want in zip(grads, grads0):
        assert _rel(got, want) <= 1e-6


def test_fused_mlp_input_gradient_is_not_differentiated_again():
    """An input gradient through the fused path that keeps its graph
    (``create_graph``, as the eikonal's) raises, with the leaves wanted or
    not, never a gradient without a graph (a silent zero in the double
    backward); without ``create_graph`` it is the other path's."""
    mlp, params, pts = _mlp_pair("sdf")
    for lay in params["layers"]:
        for t in lay.values():
            t.requires_grad_(True)
    x = pts.clone().requires_grad_(True)
    for g_out in (None, torch.ones((pts.shape[0], 1), requires_grad=True)):
        y = _once(mlp, params, x)
        with pytest.raises(RuntimeError, match="cannot differentiate twice"):
            torch.autograd.grad(y, x, g_out if g_out is not None
                                else torch.ones_like(y), create_graph=True)
    (g,) = torch.autograd.grad(_once(mlp, params, x).sum(), x)
    (g0,) = torch.autograd.grad(_previous_path(mlp, params, x).sum(), x)
    assert _rel(g, g0) <= 1e-6


@pytest.fixture(scope="module")
def tiny_scene():
    """``chip_smoke.py``'s tiny scene on the CPU (the f3c field's width)."""
    import chip_smoke

    return chip_smoke.build_scene("tiny", "cpu", seed_steps=30)


def test_extract_with_deform_gradient_equals_previous_path(tiny_scene,
                                                           monkeypatch):
    """``GeometryModel.extract`` with ``deform`` and the SDF MLP requiring
    grad: its grid query on the fused path (every layer), and the
    gradients of ``deform`` and the layers from the extracted vertices and
    SDF equal the product + ``bias_softplus100`` path's."""
    model = tiny_scene["model"]
    geo = tiny_scene["params"]["geometry"]
    gen = torch.Generator().manual_seed(12)
    deform = (torch.rand(geo["deform"].shape, generator=gen) - 0.5) * 0.2
    layers = model.sdf_mlp.n_hidden + 1
    results = []
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(ls, "fusable", lambda *a: False)
        leaves = [deform.clone().requires_grad_(True)] + [
            t.clone().requires_grad_(True) for lay in geo["sdf_net"]["layers"]
            for t in (lay["w"], lay["b"])]
        p = dict(geo, deform=leaves[0], sdf_net={"layers": [
            {"w": leaves[1 + 2 * i], "b": leaves[2 + 2 * i]}
            for i in range(layers + 1)]})
        before = _paths()
        mesh, sdf = model.extract(p)
        assert _paths(before) == ((layers, 0) if fused else (0, layers))
        assert int(mesh.vert_valid.sum()) > 0
        wv = torch.randn(mesh.verts.shape, generator=torch.Generator()
                         .manual_seed(13))
        ws = torch.randn(sdf.shape, generator=torch.Generator()
                         .manual_seed(14))
        loss = (mesh.verts * wv).sum() + (sdf * ws).sum()
        results.append((sdf, torch.autograd.grad(loss, leaves)))
    (sdf, grads), (sdf0, grads0) = results
    assert torch.equal(sdf, sdf0)
    assert float(grads0[0].abs().max()) > 0
    for got, want in zip(grads, grads0):
        assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("stage,counts", [("init", (1, 1)),
                                          ("split", (1, 2))])
def test_tick_grid_query_fused_eikonal_not(tiny_scene, stage, counts):
    """One init tick's gradients: the grid query, whose points carry
    ``deform``'s gradient, on the fused path, the eikonal's on the other:
    7 layers each at the f3c width; the split tick's grid query fused and
    both halves' eikonals not (7 / 14)."""
    import chip_smoke
    from d3human_tpu_torch.train.optim import named_leaves
    from d3human_tpu_torch.train.step import loss_and_grads

    sc = tiny_scene
    layers = sc["model"].sdf_mlp.n_hidden + 1
    assert layers == 7
    paths = [k for k, _ in named_leaves(sc["params"])
             if k.startswith("geometry/")]
    assert "geometry/deform" in paths
    before = _paths()
    _, grads = loss_and_grads(
        stage, sc["model"], sc["tex"], sc["perceptual"], sc["perc_params"],
        sc["params"], sc["target"], 7, sc["cfg"], paths, sc["raster_opts"],
        draws=chip_smoke.tick_draws(sc["cfg"], stage, seed=1))
    assert _paths(before) == (counts[0] * layers, counts[1] * layers)
    assert float(grads["geometry/deform"].abs().max()) > 0
