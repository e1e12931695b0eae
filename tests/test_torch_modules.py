"""Module-by-module parity of the PyTorch port with the JAX package on the
small scene of ``__graft_entry__._small_setup`` (CPU, plain kernel
versions). Inputs come from one seed and go through both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import JAX_RASTER_OPTS, RASTER_OPTS, jax_small, port_small

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    j = jax_small()
    return j, port_small(j)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def test_tet_grid_arrays_equal():
    from d3human_tpu.ops.tet_grid import make_tet_grid as jgrid
    from d3human_tpu_torch.ops.tet_grid import make_tet_grid as tgrid

    kw = dict(res=(6, 9, 5), bounds=((-0.6, -0.8, -0.4), (0.6, 0.8, 0.4)),
              y_offset=-0.1919, scale=1.2,
              crop_box=((-0.3, -0.5, -0.2), (0.25, 0.6, 0.3)))
    a, b = jgrid(**kw), tgrid(device="cpu", **kw)
    assert tuple(a.dims) == b.dims
    for name in ("verts", "tets", "edges", "tet_edges"):
        np.testing.assert_array_equal(_np(getattr(b, name)),
                                      np.asarray(getattr(a, name)))


def test_f3c_crop_window_matches(both):
    """The 128^3 lattice cropped to the synthetic template + 0.1, as the
    full-width scene builds it: the same windows on both sides."""
    from d3human_tpu.ops.tet_grid import crop_window as jwin
    from d3human_tpu_torch.ops.tet_grid import crop_window, template_crop_box

    j, p = both
    bounds = ((-0.6, -0.8, -0.4), (0.6, 0.8, 0.4))
    jt = np.asarray(j["scene"].canon.vs_template)[0]
    jbox = (tuple(jt.min(0) - 0.1), tuple(jt.max(0) + 0.1))
    box = template_crop_box(_np(p["scene"].canon.vs_template[0]), 0.1)
    got = crop_window((128,) * 3, bounds, 0.0, 1.0, box)
    assert got == jwin((128,) * 3, bounds, 0.0, 1.0, jbox)
    assert [i1 - i0 for i0, i1 in got] == [64, 113, 90]


def test_mlp_and_posenc_match(both):
    j, p = both
    pts = np.random.default_rng(0).uniform(-1, 1, (257, 3)).astype(np.float32)
    want = j["model"].sdf_mlp.apply(j["params"]["geometry"]["sdf_net"],
                                    jnp.asarray(pts))
    got = p["model"].sdf_mlp.apply(p["params"]["geometry"]["sdf_net"],
                                   torch.as_tensor(pts))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _extract_inputs(j):
    g = j["params"]["geometry"]
    model = j["model"]
    v_def = model.deformed_grid(g)
    sdf = model.query_sdf(g, v_def)
    return np.asarray(v_def), np.asarray(sdf), np.asarray(g["msdf"])


def test_marching_tets_matches(both):
    from d3human_tpu.ops.marching_tets import gshell_extract as jext
    from d3human_tpu_torch.ops.marching_tets import gshell_extract as text

    j, p = both
    pos, sdf, msdf = _extract_inputs(j)
    mv, mt = j["cfg"].geometry.max_verts, j["cfg"].geometry.max_tets
    a = jext(j["model"].grid, jnp.asarray(pos), jnp.asarray(sdf),
             jnp.asarray(msdf), mv, mt)
    b = text(p["model"].grid, torch.as_tensor(pos), torch.as_tensor(sdf),
             torch.as_tensor(msdf), mv, mt)
    assert int(b.n_cross) == int(a.n_cross) > 0
    assert int(b.n_valid_tets) == int(a.n_valid_tets) > 0
    for name in ("faces", "face_valid", "vert_valid", "faces_wt",
                 "face_wt_valid"):
        np.testing.assert_array_equal(_np(getattr(b, name)),
                                      np.asarray(getattr(a, name)), name)
    for name in ("verts", "verts_wt", "msdf_aug"):
        np.testing.assert_allclose(_np(getattr(b, name)),
                                   np.asarray(getattr(a, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_sdf_reg_loss_matches(both):
    from d3human_tpu.ops.marching_tets import sdf_reg_loss as jreg
    from d3human_tpu_torch.ops.marching_tets import sdf_reg_loss as treg

    j, p = both
    _, sdf, _ = _extract_inputs(j)
    want = float(jreg(jnp.asarray(sdf), j["model"].grid))
    got = float(treg(torch.as_tensor(sdf), p["model"].grid))
    assert got == pytest.approx(want, rel=1e-5)


def test_lbs_forward_matches(both):
    j, p = both
    pts = np.random.default_rng(1).uniform(-0.5, 0.5, (300, 3)).astype(
        np.float32)
    jm, pm = j["model"], p["model"]
    want = jm.pose_verts(jnp.asarray(pts), j["params"]["pose"], 1)
    got = pm.pose_verts(torch.as_tensor(pts), p["params"]["pose"], 1)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _posed_mesh(j):
    m = j["model"].get_meshes(j["params"]["geometry"], j["params"]["pose"], 0)
    return (np.asarray(m.verts_posed), np.asarray(m.mesh.faces),
            np.asarray(m.mesh.face_valid), np.asarray(m.mesh.msdf_aug))


def test_rasterize_matches_pallas_semantics(both):
    from d3human_tpu.ops.rasterizer import rasterize as jrast
    from d3human_tpu.ops.rasterizer import xfm_points as jxfm
    from d3human_tpu_torch.ops.rasterizer import rasterize as trast

    j, p = both
    verts, faces, fvalid, _ = _posed_mesh(j)
    res = tuple(j["cfg"].render.train_res)
    clip = np.asarray(jxfm(jnp.asarray(verts), j["target"]["mvp"]))
    a = jrast(jnp.asarray(clip), jnp.asarray(faces), jnp.asarray(fvalid), res,
              **JAX_RASTER_OPTS)
    b = trast(torch.as_tensor(clip), torch.as_tensor(faces),
              torch.as_tensor(fvalid), res, **RASTER_OPTS)
    assert (np.asarray(a.tri_id) > 0).sum() > 50
    np.testing.assert_array_equal(_np(b.tri_id), np.asarray(a.tri_id))
    np.testing.assert_array_equal(_np(b.zbuf), np.asarray(a.zbuf))
    assert int(b.n_max_tile) == int(a.n_max_tile)
    assert int(b.n_big) == int(a.n_big)


def test_render_compact_lean_buffers_match(both):
    from d3human_tpu.render.pipeline import render_mesh_compact as jrender
    from d3human_tpu_torch.render.pipeline import render_mesh_compact as trender

    j, p = both
    verts, faces, fvalid, msdf = _posed_mesh(j)
    res = tuple(j["cfg"].render.train_res)
    t = j["target"]
    a = jrender(jax.random.PRNGKey(0), jnp.asarray(verts), jnp.asarray(verts),
                jnp.asarray(faces), jnp.asarray(fvalid), t["mvp"],
                t["campos"], res, None, None, t["background"],
                msdf_attr=jnp.asarray(msdf), raster_opts=JAX_RASTER_OPTS,
                max_covered_frac=0.5, shade=False, need_smoothness=False)
    b = trender(None, torch.as_tensor(verts), torch.as_tensor(verts),
                torch.as_tensor(faces), torch.as_tensor(fvalid),
                p["target"]["mvp"], p["target"]["campos"], res, None, None,
                p["target"]["background"], msdf_attr=torch.as_tensor(msdf),
                raster_opts=RASTER_OPTS, max_covered_frac=0.5, shade=False,
                need_smoothness=False)
    for name in ("shaded", "geometric_normal", "msdf_image", "alpha"):
        np.testing.assert_allclose(_np(getattr(b, name)),
                                   np.asarray(getattr(a, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(_np(b.visible_faces),
                                  np.asarray(a.visible_faces))
    for k in ("n_cov", "aa_pairs_x", "aa_pairs_y"):
        assert int(b.stats[k]) == int(a.stats[k]), k


@pytest.mark.parametrize("hw", [(32, 32), (33, 31)])
def test_perceptual_matches(both, hw):
    j, p = both
    rng = np.random.default_rng(hw[0])
    x = rng.random((1, *hw, 3)).astype(np.float32)
    y = rng.random((1, *hw, 3)).astype(np.float32)
    want = float(j["perceptual"].loss(j["perc_params"], jnp.asarray(x),
                                      jnp.asarray(y)))
    got = float(p["perceptual"].loss(p["perc_params"], torch.as_tensor(x),
                                     torch.as_tensor(y)))
    assert got == pytest.approx(want, rel=1e-5)


def test_eikonal_samples_match(both):
    """Injected JAX draws give the JAX package's surface samples."""
    from d3human_tpu.ops.mesh_ops import sample_points_on_mesh as jsample
    from d3human_tpu_torch.ops.mesh_ops import sample_points_on_mesh as tsample
    from torch_parity import eik_draws

    j, p = both
    verts, faces, fvalid, _ = _posed_mesh(j)
    n = 256
    _, k_sample = jax.random.split(jax.random.PRNGKey(3))
    want = jsample(k_sample, jnp.asarray(verts), jnp.asarray(faces), n,
                   jnp.asarray(fvalid))
    got = tsample(torch.as_tensor(verts), torch.as_tensor(faces), n,
                  torch.as_tensor(fvalid), draws=eik_draws(n))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------- split slice

def test_auto_normals_match(both):
    """Vertex normals through the scatter (plain version here), with dead
    faces masked and the +z fallback on unreferenced vertices: abs 1e-5."""
    from d3human_tpu.ops.mesh_ops import auto_normals as jauto
    from d3human_tpu_torch.ops.mesh_ops import auto_normals as tauto
    from d3human_tpu_torch.ops.mesh_ops import face_normals

    j, p = both
    verts, faces, fvalid, _ = _posed_mesh(j)
    want = np.asarray(jauto(jnp.asarray(verts), jnp.asarray(faces),
                            jnp.asarray(fvalid)))
    tv, tf, tm = (torch.as_tensor(verts), torch.as_tensor(faces),
                  torch.as_tensor(fvalid))
    got = tauto(tv, tf, tm)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5)
    assert (want == [0.0, 0.0, 1.0]).all(-1).any()       # the fallback ran
    again = tauto(tv, tf, tm, fn_raw=face_normals(tv, tf, normalize=False))
    assert torch.equal(got, again)


def test_extract_pair_matches_jax_and_two_singles(both):
    from d3human_tpu.ops.marching_tets import gshell_extract_pair as jpair
    from d3human_tpu_torch.ops.marching_tets import (
        gshell_extract, gshell_extract_pair,
    )

    j, p = both
    pos, sdf, _ = _extract_inputs(j)
    msdf = np.tanh(3.0 * pos[:, 1] + 0.2).astype(np.float32)
    mv, mt = j["cfg"].geometry.max_verts, j["cfg"].geometry.max_tets
    ja = jpair(j["model"].grid, jnp.asarray(pos), jnp.asarray(sdf),
               jnp.asarray(msdf), mv, mt)
    args = (p["model"].grid, torch.as_tensor(pos), torch.as_tensor(sdf),
            torch.as_tensor(msdf), mv, mt)
    cloth, body, raw = gshell_extract_pair(*args)
    np.testing.assert_allclose(_np(raw), np.asarray(ja[2]), rtol=1e-5,
                               atol=1e-5)
    for got, want, sign in ((cloth, ja[0], 1.0), (body, ja[1], -1.0)):
        assert int(got.face_valid.sum()) == int(want.face_valid.sum()) > 0
        for name in ("faces", "face_valid", "vert_valid"):
            np.testing.assert_array_equal(_np(getattr(got, name)),
                                          np.asarray(getattr(want, name)))
        for name in ("verts", "msdf_aug"):
            np.testing.assert_allclose(_np(getattr(got, name)),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        single = gshell_extract(*args, msdf_sign=sign)
        for a, b in zip(got, single):                    # bit for bit
            assert torch.equal(a, b)


def test_get_meshes_pair_matches_jax_and_two_singles(both):
    j, p = both
    msdf = np.tanh(3.0 * np.asarray(j["model"].grid.verts)[:, 1] + 0.2)
    jg = dict(j["params"]["geometry"], msdf=jnp.asarray(msdf, jnp.float32))
    tg = dict(p["params"]["geometry"],
              msdf=torch.as_tensor(msdf.astype(np.float32)))
    want = j["model"].get_meshes_pair(jg, j["params"]["pose"], 1)
    got = p["model"].get_meshes_pair(tg, p["params"]["pose"], 1)
    for g, w, sign in zip(got, want, (1.0, -1.0)):
        np.testing.assert_allclose(_np(g.verts_posed),
                                   np.asarray(w.verts_posed), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(_np(g.mesh.faces),
                                      np.asarray(w.mesh.faces))
        single = p["model"].get_meshes(tg, p["params"]["pose"], 1,
                                       msdf_sign=sign)
        assert torch.equal(g.verts_posed, single.verts_posed)
        assert torch.equal(g.verts_template, single.verts_template)
        assert torch.equal(g.sdf, single.sdf)
        for a, b in zip(g.mesh, single.mesh):
            assert torch.equal(a, b)


def _layered_soup(seed=3, n=60):
    """A soup of overlapping triangles at several depths (the JAX
    package's own peel test scene), as clip-space vertices."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-0.7, 0.7, (n, 1, 2))
    xy = ctr + rng.uniform(-0.45, 0.45, (n, 3, 2))
    z = rng.uniform(0.1, 0.9, (n, 1, 1)) + rng.uniform(-0.05, 0.05, (n, 3, 1))
    clip = np.concatenate([xy, z, np.ones((n, 3, 1))], -1).reshape(-1, 4)
    faces = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return clip.astype(np.float32), faces, np.ones(n, bool)


@pytest.mark.parametrize("layers", [1, 2, 3, 4])
def test_rasterize_layers_match_pallas_peel(layers):
    """Depth peeling against the JAX package's Pallas peel kernel in
    interpret mode: ids and depths of every layer exactly equal, a pixel
    that misses stays missed, depths grow strictly along the layers."""
    from d3human_tpu.ops.rasterizer import rasterize as jrast
    from d3human_tpu_torch.ops.rasterizer import rasterize as trast

    clip, faces, fvalid = _layered_soup()
    res = (32, 48)
    a = jrast(jnp.asarray(clip), jnp.asarray(faces), jnp.asarray(fvalid),
              res, layers=layers, **JAX_RASTER_OPTS)
    b = trast(torch.as_tensor(clip), torch.as_tensor(faces),
              torch.as_tensor(fvalid), res, layers=layers, **RASTER_OPTS)
    if layers == 1:
        a, b = (a,), (b,)
    assert len(b) == layers
    for la, lb in zip(a, b):
        np.testing.assert_array_equal(_np(lb.tri_id), np.asarray(la.tri_id))
        np.testing.assert_array_equal(_np(lb.zbuf), np.asarray(la.zbuf))
    hits = [int((l.tri_id > 0).sum()) for l in b]
    assert hits[0] > 200 and all(h > 0 for h in hits)
    for near, far in zip(b[:-1], b[1:]):
        both_hit = (near.tri_id > 0) & (far.tri_id > 0)
        assert not bool(((near.tri_id == 0) & (far.tri_id > 0)).any())
        assert bool((far.zbuf[both_hit] >= near.zbuf[both_hit]).all())
        assert bool((far.tri_id[both_hit] != near.tri_id[both_hit]).all())


@pytest.mark.parametrize("name", ["smape", "mse", "logl1", "logl2", "relmse"])
def test_image_loss_matches(name):
    """Value rel 1e-5 and gradient rel-L2 1e-5, on HDR-range inputs that
    reach both sides of the sRGB knee."""
    from d3human_tpu.ops.image_loss import make_loss_fn as jmake
    from d3human_tpu_torch.ops.image_loss import make_loss_fn as tmake

    rng = np.random.default_rng(0)
    img = (rng.random((9, 11, 3)) ** 4 * 3.0).astype(np.float32)
    ref = (rng.random((9, 11, 3)) ** 4 * 3.0).astype(np.float32)
    want, jg = jax.value_and_grad(jmake(name))(jnp.asarray(img),
                                               jnp.asarray(ref))
    x = torch.as_tensor(img).requires_grad_(True)
    got = tmake(name)(x, torch.as_tensor(ref))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    (tg,) = torch.autograd.grad(got, x)
    assert (np.linalg.norm(_np(tg) - np.asarray(jg))
            <= 1e-5 * np.linalg.norm(np.asarray(jg)))


def test_psnr_ssim_and_srgb_match():
    from d3human_tpu.ops import image_loss as JI
    from d3human_tpu_torch.ops import image_loss as TI

    rng = np.random.default_rng(1)
    a = rng.random((2, 16, 14, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.1, 0, 1).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    assert float(TI.ssim(ta, tb)) == pytest.approx(
        float(JI.ssim(jnp.asarray(a), jnp.asarray(b))), rel=1e-5)
    assert float(TI.ssim(ta[0], tb[0])) == pytest.approx(
        float(JI.ssim(jnp.asarray(a[0]), jnp.asarray(b[0]))), rel=1e-5)
    mse = ((a - b) ** 2).mean()
    assert float(TI.mse_to_psnr(torch.tensor(mse))) == pytest.approx(
        float(JI.mse_to_psnr(jnp.asarray(mse))), rel=1e-6)
    np.testing.assert_allclose(_np(TI.srgb_to_rgb(ta)),
                               np.asarray(JI.srgb_to_rgb(jnp.asarray(a))),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(TI.rgb_to_srgb(ta)),
                               np.asarray(JI.rgb_to_srgb(jnp.asarray(a))),
                               rtol=1e-5, atol=1e-7)


def test_regularizers_match():
    """chroma_loss and both smoothness forms: value rel 1e-5, and the
    chroma gradient rel-L2 1e-5."""
    from d3human_tpu.render import regularizer as JR
    from d3human_tpu_torch.render import regularizer as TR

    rng = np.random.default_rng(2)
    kd = rng.random((8, 9, 4)).astype(np.float32)
    kd[0, 0, :3] = 0.0                                    # the eps clamp
    ref = rng.random((8, 9, 4)).astype(np.float32)
    want, jg = jax.value_and_grad(JR.chroma_loss)(jnp.asarray(kd),
                                                  jnp.asarray(ref), 0.3)
    x = torch.as_tensor(kd).requires_grad_(True)
    got = TR.chroma_loss(x, torch.as_tensor(ref), 0.3)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    (tg,) = torch.autograd.grad(got, x)
    assert (np.linalg.norm(_np(tg) - np.asarray(jg))
            <= 1e-5 * np.linalg.norm(np.asarray(jg)))

    g3 = [rng.random((8, 9, 4)).astype(np.float32) for _ in range(3)]
    want = JR.material_smoothness_grad(*map(jnp.asarray, g3), 0.1, 0.05,
                                       0.025)
    got = TR.material_smoothness_grad(*map(torch.as_tensor, g3), 0.1, 0.05,
                                      0.025)
    assert float(got) == pytest.approx(float(want), rel=1e-5)

    stats = {"npix": 72, "jitter_subsample": 2,
             "kd_grad": rng.random((20, 3)).astype(np.float32),
             "ks_grad": rng.random((20, 3)).astype(np.float32),
             "nrm_grad": rng.random((20, 3)).astype(np.float32)}
    want = JR.material_smoothness_compact(
        {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
         for k, v in stats.items()}, 0.1, 0.05, 0.025)
    got = TR.material_smoothness_compact(
        {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
         for k, v in stats.items()}, 0.1, 0.05, 0.025)
    assert float(got) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("hw,crop", [((40, 36), 24), ((20, 20), 448)])
def test_random_crop_pair_matches(hw, crop):
    """The JAX package's crop corner injected: the same two crops, exact;
    a generator draws a corner inside the image."""
    from d3human_tpu.models.perceptual import random_crop_pair as jcrop
    from d3human_tpu_torch.models.perceptual import random_crop_pair as tcrop

    rng = np.random.default_rng(3)
    a = rng.random((1, *hw, 3)).astype(np.float32)
    b = rng.random((1, *hw, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    kh, kw = jax.random.split(key)
    top = int(jax.random.randint(kh, (), 0, max(hw[0] - crop, 1)))
    left = int(jax.random.randint(kw, (), 0, max(hw[1] - crop, 1)))
    wa, wb = jcrop(key, jnp.asarray(a), jnp.asarray(b), crop)
    ga, gb = tcrop(None, torch.as_tensor(a), torch.as_tensor(b), crop,
                   offsets=(top, left))
    np.testing.assert_array_equal(_np(ga), np.asarray(wa))
    np.testing.assert_array_equal(_np(gb), np.asarray(wb))
    ra, rb = tcrop(torch.Generator().manual_seed(0), torch.as_tensor(a),
                   torch.as_tensor(b), crop)
    assert ra.shape == ga.shape == rb.shape
    t = torch.as_tensor(a)
    win = t.unfold(1, ra.shape[1], 1).unfold(2, ra.shape[2], 1)
    assert bool((win.permute(0, 1, 2, 4, 5, 3) == ra[:, None, None]).all(
        dim=(-1, -2, -3)).any())


def test_convert_round_trip_keeps_material_and_light(both):
    """params_from_jax keeps all four parts, leaf by leaf and bit for bit;
    a tree without material and light converts to one without."""
    from d3human_tpu_torch.convert import params_from_jax
    from d3human_tpu_torch.train.optim import named_leaves
    from torch_parity import to_np

    j, p = both
    tree = to_np(j["params"])
    got = params_from_jax(tree, "cpu")
    assert set(got) == {"geometry", "pose", "material", "light"}
    assert [tuple(t.shape) for t in got["material"]["encoder"]["table"]] == [
        tuple(t.shape) for t in tree["material"]["encoder"]["table"]]
    flat_want = jax.tree_util.tree_leaves(tree)
    flat_got = [t for _, t in named_leaves(got)]
    assert len(flat_got) == len(flat_want)
    back = {k: v.numpy() for k, v in named_leaves(got)}
    for path, want in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        np.testing.assert_array_equal(back[key], want, key)
    assert set(params_from_jax({"geometry": tree["geometry"],
                                "pose": tree["pose"]}, "cpu")) == {
        "geometry", "pose"}


@pytest.mark.parametrize("layers", [0, 1, 4, 5])
def test_render_config_layers_range_matches(layers):
    """Depth peeling supports 1-4 layers: both packages' RenderConfig
    accept and refuse the same values, and the conversion carries them."""
    from d3human_tpu.config import Config as JConfig
    from d3human_tpu.config import RenderConfig as JRender
    from d3human_tpu_torch.config import RenderConfig, from_jax_config

    if 1 <= layers <= 4:
        jcfg = JConfig(render=JRender(layers=layers, spp=2))
        got = from_jax_config(jcfg).render
        assert (got.layers, got.spp) == (layers, 2)
        assert got == RenderConfig(
            train_res=got.train_res, layers=layers, spp=2,
            probe_res=got.probe_res, max_covered_frac=got.max_covered_frac,
            jitter_subsample=got.jitter_subsample, aa_dense=got.aa_dense,
            init_shading=got.init_shading)
    else:
        with pytest.raises(ValueError, match="1-4 layers"):
            JRender(layers=layers)
        with pytest.raises(ValueError, match="1-4 layers"):
            RenderConfig(layers=layers)
