"""The last public functions of the JAX package with a counterpart of the
same name in the port, each against JAX on seeded inputs: ``sdf_gradient``
(and its double backward), ``vertices2joints`` and ``blend_shapes`` (and
``lbs``, which uses them), ``shading_loss``, ``tet_type_corner_offsets``,
the native engine's one-shot ``mesh_sdf_host`` and ``available``, and
``native.build_framecache``."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _mlps():
    """The JAX SDF MLP at a small width and the port's with its weights."""
    from d3human_tpu.models.fields import MLP as JMLP
    from d3human_tpu_torch.convert import tree_from_jax
    from d3human_tpu_torch.models.fields import MLP

    kw = dict(n_freq=4, d_hidden=32, n_hidden=3, skip_in=(1,), d_out=1)
    jm, tm = JMLP(**kw), MLP(**kw)
    jp = jm.init(jax.random.PRNGKey(2))
    return jm, jp, tm, tree_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_sdf_gradient_matches_jax():
    """The input gradient rel 1e-5, and the eikonal term's gradient into
    the weights (the double backward, ``create_graph``) rel-L2 1e-5."""
    from d3human_tpu.models.fields import sdf_gradient as jgrad
    from d3human_tpu_torch.models.fields import sdf_gradient
    from d3human_tpu_torch.train.optim import named_leaves

    jm, jp, tm, tp = _mlps()
    pts = np.random.default_rng(0).uniform(-1, 1, (300, 3)).astype(
        np.float32)
    want = jgrad(jm, jp, jnp.asarray(pts))
    got = sdf_gradient(tm, tp, torch.as_tensor(pts))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)

    def eik(p):
        g = jgrad(jm, p, jnp.asarray(pts))
        return jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    jw = dict(named_leaves(jax.tree.map(
        lambda a: torch.as_tensor(np.array(a)), jax.grad(eik)(jp))))
    leaves = dict(named_leaves(tp))
    for t in leaves.values():
        t.requires_grad_(True)
    g = sdf_gradient(tm, tp, torch.as_tensor(pts))
    loss = ((torch.linalg.norm(g, dim=-1) - 1.0) ** 2).mean()
    # the output bias moves no input gradient: None here, zeros in JAX
    tw = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    assert set(jw) == set(leaves)
    for k, w in zip(leaves, tw):
        want_k = _np(jw[k])
        if w is None:
            assert not want_k.any(), k
            continue
        assert _rel_l2(_np(w), want_k) <= 1e-5, k
    # under no_grad it still differentiates the field
    with torch.no_grad():
        again = sdf_gradient(tm, tp, torch.as_tensor(pts))
    assert torch.allclose(again, got.detach())


def _lbs_inputs(seed=1, B=2, V=50, J=4, L=5):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        betas=rng.standard_normal((B, L)).astype(f32),
        pose=0.3 * rng.standard_normal((B, J * 3)).astype(f32),
        v_template=rng.standard_normal((V, 3)).astype(f32),
        shapedirs=0.1 * rng.standard_normal((V, 3, L)).astype(f32),
        posedirs=0.01 * rng.standard_normal(((J - 1) * 9, V * 3)).astype(f32),
        J_regressor=rng.dirichlet(np.ones(V), J).astype(f32),
        lbs_weights=rng.dirichlet(np.ones(J), V).astype(f32))


def test_vertices2joints_and_blend_shapes_match_jax():
    from d3human_tpu_torch.models.smplx import lbs as TL

    # the JAX package's smplx/__init__ exports the function under the name
    JL = importlib.import_module("d3human_tpu.models.smplx.lbs")

    a = _lbs_inputs()
    verts = a["v_template"][None].repeat(2, 0)
    np.testing.assert_allclose(
        _np(TL.vertices2joints(torch.as_tensor(a["J_regressor"]),
                               torch.as_tensor(verts))),
        np.asarray(JL.vertices2joints(jnp.asarray(a["J_regressor"]),
                                      jnp.asarray(verts))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _np(TL.blend_shapes(torch.as_tensor(a["betas"]),
                            torch.as_tensor(a["shapedirs"]))),
        np.asarray(JL.blend_shapes(jnp.asarray(a["betas"]),
                                   jnp.asarray(a["shapedirs"]))),
        rtol=1e-5, atol=1e-6)


def test_lbs_uses_them_and_matches_jax(monkeypatch):
    """``lbs`` takes its shape blend and its joints from the two functions
    (each called once) and equals the JAX package's lbs."""
    from d3human_tpu_torch.models.smplx import lbs as TL

    # the JAX package's smplx/__init__ exports the function under the name
    JL = importlib.import_module("d3human_tpu.models.smplx.lbs")

    a = _lbs_inputs()
    parents = (-1, 0, 1, 1)
    calls = {"vertices2joints": 0, "blend_shapes": 0}
    for name in calls:
        fn = getattr(TL, name)

        def counted(*x, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*x)
        monkeypatch.setattr(TL, name, counted)
    got = TL.lbs(parents=parents,
                 **{k: torch.as_tensor(v) for k, v in a.items()})
    want = JL.lbs(parents=parents, **{k: jnp.asarray(v) for k, v in a.items()})
    assert calls == {"vertices2joints": 1, "blend_shapes": 1}
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_shading_loss_matches_jax():
    """Value rel 1e-5 and the gradients of both light buffers rel-L2 1e-5,
    with a masked-out region and a dark diffuse pixel (the eps clamps)."""
    from d3human_tpu.render import regularizer as JR
    from d3human_tpu_torch.render import regularizer as TR

    rng = np.random.default_rng(3)
    dl = rng.random((2, 8, 9, 3)).astype(np.float32)
    sl = 0.2 * rng.random((2, 8, 9, 3)).astype(np.float32)
    ref = rng.random((2, 8, 9, 4)).astype(np.float32)
    ref[..., 3] = (ref[..., 3] > 0.3).astype(np.float32)
    dl[0, 0, 0] = 0.0
    want, jg = jax.value_and_grad(JR.shading_loss, argnums=(0, 1))(
        jnp.asarray(dl), jnp.asarray(sl), jnp.asarray(ref), 0.5, 0.25)
    x = torch.as_tensor(dl).requires_grad_(True)
    y = torch.as_tensor(sl).requires_grad_(True)
    got = TR.shading_loss(x, y, torch.as_tensor(ref), 0.5, 0.25)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    for g, w in zip(torch.autograd.grad(got, (x, y)), jg):
        assert _rel_l2(_np(g), np.asarray(w)) <= 1e-5


def test_tet_type_corner_offsets_match_jax():
    from d3human_tpu.ops.tet_grid import tet_type_corner_offsets as jt
    from d3human_tpu_torch.ops.tet_grid import KUHN_PATHS
    from d3human_tpu_torch.ops.tet_grid import tet_type_corner_offsets

    assert tet_type_corner_offsets() == jt() == KUHN_PATHS
    assert len(tet_type_corner_offsets()) == 6


@pytest.mark.parametrize("conv", ["neg_inside", "pos_inside", "unsigned"])
def test_native_mesh_sdf_host_equals_jax(conv):
    """The one-shot engine query bit for bit against the JAX package's
    (its committed library, loaded as it is); ``available`` True where
    g++ builds the library, as here."""
    from d3human_tpu_torch.native import meshsdf
    from test_pipeline import icosphere
    from torch_parity import load_jax_engine

    J = load_jax_engine()[0]
    v, f = (np.asarray(a) for a in icosphere(radius=0.5, n=2))
    pts = np.random.default_rng(4).uniform(-1, 1, (500, 3)).astype(
        np.float32)
    want = J.mesh_sdf_host(pts, v, f, conv)
    got = meshsdf.mesh_sdf_host(pts, v, f, conv)
    np.testing.assert_array_equal(got, want)
    assert meshsdf.available()


def test_native_available_only_false_without_the_toolchain(monkeypatch):
    """``available`` is False for a failed build (a ``BuildError``) and
    passes any other error on; ``mesh_sdf_host`` raises the build error
    (it does not answer another way)."""
    import d3human_tpu_torch.native.meshsdf as N
    from d3human_tpu_torch.native import BuildError

    def no_compiler():
        raise BuildError("g++ could not run")

    monkeypatch.setattr(N, "_load", no_compiler)
    assert not N.available()
    with pytest.raises(BuildError):
        N.mesh_sdf_host(np.zeros((1, 3), np.float32),
                        np.eye(3, dtype=np.float32),
                        np.asarray([[0, 1, 2]]))

    def broken():
        raise RuntimeError("not a build failure")

    monkeypatch.setattr(N, "_load", broken)
    with pytest.raises(RuntimeError):
        N.available()


def test_build_framecache(tmp_path, monkeypatch):
    """``build_framecache`` builds ``libframecache.so`` into the build
    directory (never beside the source), reuses a fresh one, and rebuilds
    with ``force``; the frame cache loads it."""
    import ctypes
    import os

    from d3human_tpu_torch import native

    monkeypatch.setattr(native, "BUILD", tmp_path)
    lib = native.build_framecache()
    assert lib == tmp_path / "libframecache.so" and lib.exists()
    assert not (native.SRC / "libframecache.so").exists()
    ctypes.CDLL(str(lib))
    # newer than its source: reused; with force: built again
    later = (native.SRC / "framecache.cpp").stat().st_mtime + 1000
    os.utime(lib, (later, later))
    assert native.build_framecache() == lib
    assert lib.stat().st_mtime == later
    assert native.build_framecache(force=True) == lib
    assert lib.stat().st_mtime != later
