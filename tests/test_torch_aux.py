"""The port's API-only modules against the JAX package on the CPU: the
dense ``antialias``, ``edge_normal_consistency_loss`` and its gradient,
the bilateral denoiser, the cubemap functions, ``CondBNDecoder``,
``LPIPSLike``, the material files byte for byte and the tetrahedral
meshers. Values and gradients abs 1e-5 or rel 1e-5 (rel-L2 1e-4 for
gradients), the host meshers and the material files exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_pipeline import icosphere
from torch_parity import to_np

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _clip_mesh(res=(24, 32)):
    """A bumpy sphere in clip space before a camera, rasterized by the JAX
    oracle: (clip [V, 4], faces, Rast as numpy)."""
    from d3human_tpu.ops.rasterizer import rasterize_bruteforce, xfm_points
    from d3human_tpu.render.camera import look_at, perspective

    v, f = icosphere(radius=0.5, n=2)
    v = v * (1.0 + 0.15 * np.sin(5.0 * v[:, :1]))
    mvp = (perspective(0.9, res[1] / res[0], 0.1, 100.0)
           @ look_at((0.3, 0.2, 2.0), (0.0, 0.0, 0.0))).astype(np.float32)
    clip = np.asarray(xfm_points(jnp.asarray(v, jnp.float32),
                                 jnp.asarray(mvp)))
    f = f.astype(np.int32)
    rast = rasterize_bruteforce(jnp.asarray(clip), jnp.asarray(f),
                                jnp.ones(len(f), bool), res)
    return clip, f, rast


def test_antialias_matches():
    from d3human_tpu.ops.rasterizer import antialias as jaa
    from d3human_tpu_torch.ops.rasterizer import Rast
    from d3human_tpu_torch.ops.rasterizer import antialias as taa

    clip, f, rast = _clip_mesh()
    res = rast.tri_id.shape
    assert int((np.asarray(rast.tri_id) > 0).sum()) > 100
    rng = np.random.default_rng(0)
    color = rng.uniform(size=(*res, 4)).astype(np.float32)
    w = rng.normal(size=(*res, 4)).astype(np.float32)
    jv, (jgc, jgv) = jax.jit(jax.value_and_grad(
        lambda c, v: jnp.sum(jaa(c, v, jnp.asarray(f), rast) * w),
        argnums=(0, 1)))(jnp.asarray(color), jnp.asarray(clip))
    tr = Rast(tri_id=torch.as_tensor(np.asarray(rast.tri_id)),
              zbuf=torch.as_tensor(np.asarray(rast.zbuf)))
    tc = torch.tensor(color, requires_grad=True)
    tv = torch.tensor(clip, requires_grad=True)
    out = taa(tc, tv, torch.as_tensor(f).long(), tr)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jax.jit(lambda c, v: jaa(c, v, jnp.asarray(f), rast))(
            jnp.asarray(color), jnp.asarray(clip))), rtol=0, atol=1e-5)
    assert float((out - tc).abs().max()) > 1e-3       # edges were blended
    (out * torch.as_tensor(w)).sum().backward()
    assert _rel(tc.grad.numpy(), jgc) < 1e-4
    assert _rel(tv.grad.numpy(), jgv) < 1e-4
    assert float(tv.grad.abs().max()) > 0


def test_edge_normal_consistency_loss_and_gradient():
    from d3human_tpu.ops.mesh_ops import edge_normal_consistency_loss as jl
    from d3human_tpu_torch.ops.mesh_ops import \
        edge_normal_consistency_loss as tl

    v, f = icosphere(radius=0.5, n=2)
    rng = np.random.default_rng(1)
    v = (v + rng.normal(scale=0.03, size=v.shape)).astype(np.float32)
    f = f.astype(np.int32)
    valid = rng.uniform(size=len(f)) > 0.2
    jv, jg = jax.jit(jax.value_and_grad(lambda x: jl(x, jnp.asarray(f),
                                                     jnp.asarray(valid))))(
        jnp.asarray(v))
    tv = torch.tensor(v, requires_grad=True)
    loss = tl(tv, torch.as_tensor(f).long(), torch.as_tensor(valid))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jv), rel=1e-5)
    assert float(jv) > 1e-4
    assert _rel(tv.grad.numpy(), jg) < 1e-4


def test_bilateral_denoiser():
    from d3human_tpu.ops.denoiser import BilateralDenoiser as JD
    from d3human_tpu.ops.denoiser import bilateral_denoise as jdn
    from d3human_tpu_torch.ops.denoiser import BilateralDenoiser as TD
    from d3human_tpu_torch.ops.denoiser import bilateral_denoise as tdn

    rng = np.random.default_rng(2)
    H, W = 20, 28
    color = rng.uniform(size=(H, W, 3)).astype(np.float32)
    normal = rng.normal(size=(H, W, 3)).astype(np.float32)
    depth = rng.uniform(1.0, 1.3, size=(H, W, 2)).astype(np.float32)
    wts = rng.normal(size=(H, W, 3)).astype(np.float32)
    jd, td = JD(), TD()
    for infl in (1.0, 0.3):
        jd.set_influence(infl)
        td.set_influence(infl)
        want = np.asarray(jax.jit(jd.__call__)(
            *(jnp.asarray(a) for a in (color, normal, depth))))
        got = td(*(torch.as_tensor(a) for a in (color, normal, depth)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    jg = jax.jit(jax.grad(
        lambda c, n, z: jnp.sum(jdn(c, n, z, window=5) * wts),
        argnums=(0, 1, 2)))(*(jnp.asarray(a) for a in (color, normal, depth)))
    ts = [torch.tensor(a, requires_grad=True)
          for a in (color, normal, depth)]
    (tdn(*ts, window=5) * torch.as_tensor(wts)).sum().backward()
    for t, g in zip(ts, jg):
        assert _rel(t.grad.numpy(), g) < 1e-4


def test_cubemap_functions():
    from d3human_tpu.render import cubemap as J
    from d3human_tpu_torch.render import cubemap as T

    res = 8
    np.testing.assert_array_equal(T.cube_dirs(res, "cpu").numpy(),
                                  np.asarray(J.cube_dirs(res)))
    np.testing.assert_array_equal(T.texel_solid_angles(res, "cpu").numpy(),
                                  np.asarray(J.texel_solid_angles(res)))
    rng = np.random.default_rng(3)
    ll = rng.uniform(0.1, 2.0, size=(16, 32, 3)).astype(np.float32)
    jc = J.latlong_to_cubemap(jnp.asarray(ll), res)
    tc = T.latlong_to_cubemap(torch.as_tensor(ll), res)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    cube = rng.uniform(0.1, 2.0, size=(6, res, res, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        T.cubemap_to_latlong(torch.as_tensor(cube), (12, 20)).numpy(),
        np.asarray(J.cubemap_to_latlong(jnp.asarray(cube), (12, 20))))
    np.testing.assert_allclose(
        T.diffuse_prefilter(torch.as_tensor(cube)).numpy(),
        np.asarray(J.diffuse_prefilter(jnp.asarray(cube))), rtol=1e-5,
        atol=1e-6)
    for rough in (0.0, 0.4, 1.0):
        np.testing.assert_allclose(
            T.specular_prefilter(torch.as_tensor(cube), rough).numpy(),
            np.asarray(J.specular_prefilter(jnp.asarray(cube), rough)),
            rtol=1e-5, atol=1e-6, err_msg=str(rough))
    jm = J.specular_mip_chain(jnp.asarray(cube), 4)
    tm = T.specular_mip_chain(torch.as_tensor(cube), 4)
    assert [tuple(m.shape) for m in tm] == [m.shape for m in jm]
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    # the gradient reaches the probe through the lookup and the prefilter
    tl = torch.tensor(ll, requires_grad=True)
    T.diffuse_prefilter(T.latlong_to_cubemap(tl, res)).sum().backward()
    jg = jax.grad(lambda x: jnp.sum(J.diffuse_prefilter(
        J.latlong_to_cubemap(x, res))))(jnp.asarray(ll))
    assert _rel(tl.grad.numpy(), jg) < 1e-4


def test_condbn_decoder():
    from d3human_tpu.models.condbn import CondBNDecoder as JC
    from d3human_tpu_torch.convert import tree_from_jax
    from d3human_tpu_torch.models.condbn import CondBNDecoder as TC

    kw = dict(input_dim=3, latent_dim=8, hidden_dim=16, num_hidden_layers=2,
              out_dim=3)
    jc, tc = JC(**kw), TC(**kw)
    jp = jc.init(jax.random.PRNGKey(0))
    # non-zero conditioning and residual weights, so every path carries
    jp = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(
        jax.random.PRNGKey(a.size), a.shape), jp)
    tp = tree_from_jax(to_np(jp), "cpu")
    rng = np.random.default_rng(4)
    coords = rng.normal(size=(2, 50, 3)).astype(np.float32)
    for codes in (rng.normal(size=(2, 8)).astype(np.float32),
                  rng.normal(size=(2, 50, 8)).astype(np.float32)):
        want = jc.apply(jp, jnp.asarray(coords), jnp.asarray(codes))
        got = tc.apply(tp, torch.as_tensor(coords), torch.as_tensor(codes))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jc.apply(
        p, jnp.asarray(coords), jnp.asarray(codes)) ** 2)))(jp)
    tp = jax.tree.map(lambda a: a.requires_grad_(True), tp)
    (tc.apply(tp, torch.as_tensor(coords),
              torch.as_tensor(codes)) ** 2).sum().backward()
    # all leaves at once: a bias ahead of a normalisation has a gradient
    # of rounding noise only
    assert _rel(np.concatenate([a.grad.numpy().ravel()
                                for a in jax.tree.leaves(tp)]),
                np.concatenate([np.ravel(b) for b in jax.tree.leaves(jg)])
                ) < 1e-4
    own = tc.init(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, to_np(jp)))
    out = tc.apply(own, torch.as_tensor(coords), torch.as_tensor(codes))
    assert out.shape == (2, 50, 3) and torch.isfinite(out).all()


def test_lpips_like(tmp_path):
    from d3human_tpu.models.perceptual import LPIPSLike as JL
    from d3human_tpu_torch.convert import lpips_from_jax
    from d3human_tpu_torch.models.perceptual import LPIPSLike as TL

    jl, tl = JL(channels=(8, 12, 16)), TL(channels=(8, 12, 16))
    rng = np.random.default_rng(5)
    x, y = rng.uniform(size=(2, 2, 40, 36, 3)).astype(np.float32)
    npz = str(tmp_path / "lin.npz")
    np.savez(npz, **{f"lin_{i}": rng.uniform(size=c).astype(np.float32)
                     for i, c in enumerate((8, 12, 16))})
    for weights in (None, npz):
        jp = jl.init(weights)
        tp = lpips_from_jax(to_np(jp), "cpu")
        want, jg = jax.jit(jax.value_and_grad(
            lambda a: jl.distance(jp, a, jnp.asarray(y))))(jnp.asarray(x))
        xt = torch.tensor(x, requires_grad=True)
        got = tl.distance(tp, xt, torch.as_tensor(y))
        assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
        got.backward()
        assert _rel(xt.grad.numpy(), jg) < 1e-4
        assert float(tl.distance(tp, xt, xt)) == 0.0
        own = tl.init(weights, "cpu")
        np.testing.assert_array_equal(own["lin"][0].numpy(),
                                      np.asarray(jp["lin"][0]))


def test_material_files_byte_for_byte(tmp_path):
    from d3human_tpu.render import material as J
    from d3human_tpu_torch.render import material as T

    mat = {"name": "skin", "bsdf": "pbr", "kd": [0.8, 0.25, 0.125],
           "ks": np.asarray([0.0, 0.5, 0.1], np.float32),
           "ke": np.float32([1e-3, 2.5, 3.0]), "kd_ks": {"table": 1}}
    for m in (mat, {}, {"name": "a", "ks": [1.0, 2.0, 3.0, 4.0]}):
        J.save_mtl(str(tmp_path / "j" / "m.mtl"), m)
        T.save_mtl(str(tmp_path / "t" / "m.mtl"), m)
        a = (tmp_path / "j" / "m.mtl").read_bytes()
        b = (tmp_path / "t" / "m.mtl").read_bytes()
        assert a == b
    text = ("# comment\nKd 1 1 1\nnewmtl first\nbsdf pbr\nKd 0.5 0.25 1\n"
            "map_Kd tex/kd.png\n\nnewmtl second\nKs 0 0.5 0\nKe 1 2 3\n")
    (tmp_path / "in.mtl").write_text(text)
    jm = J.load_mtl(str(tmp_path / "in.mtl"))
    tm = T.load_mtl(str(tmp_path / "in.mtl"))
    assert len(tm) == len(jm) == 2
    for a, b in zip(tm, jm):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    assert T.get_parameters(mat) == J.get_parameters(mat) == {
        "kd_ks": {"table": 1}}
    assert T.merge_materials(tm)["name"] == J.merge_materials(jm)["name"] \
        == "first_second"
    assert T.merge_materials([]) == J.merge_materials([])


def test_tetrahedralize_interior_and_delaunay_bit_for_bit(tmp_path):
    from d3human_tpu.pipeline import tetrahedralize as J
    from d3human_tpu.utils.io import write_obj
    from d3human_tpu_torch.pipeline import tetrahedralize as T
    from torch_parity import load_jax_engine

    load_jax_engine()
    v, f = icosphere(radius=0.4, n=2)
    for kw in (dict(grid_res=12, band=0.05), dict(grid_res=9)):
        for a, b in zip(T.tetrahedralize_interior(v, f, **kw),
                        J.tetrahedralize_interior(v, f, **kw)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    a = T.tetrahedralize_delaunay(v, f, max_volume=1e-3, refine_iters=2)
    b = J.tetrahedralize_delaunay(v, f, max_volume=1e-3, refine_iters=2)
    assert len(a[1]) > 100
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    mesh = str(tmp_path / "surf.obj")
    write_obj(mesh, v, f)
    T.get_tet_mesh(mesh, str(tmp_path / "t.npz"), max_volume=2e-3)
    J.get_tet_mesh(mesh, str(tmp_path / "j.npz"), max_volume=2e-3)
    with np.load(tmp_path / "t.npz") as zt, np.load(tmp_path / "j.npz") as zj:
        for k in ("v", "f"):
            np.testing.assert_array_equal(zt[k], zj[k])
    assert (tmp_path / "t.obj").read_bytes() == \
        (tmp_path / "j.obj").read_bytes()
