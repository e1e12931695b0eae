"""The port's renders against the JAX package on the small scene's posed
mesh, with the JAX package's random draws injected: the full (validation)
path with 1 and 2 depth-peeled layers, albedo and normal shading, spp 1 and
2, and the shaded branch of the compacted (training) path. Every image
buffer abs 1e-5; ids, depths, masks and counters exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import (
    JAX_RASTER_OPTS, RASTER_OPTS, compact_draw_shapes, jax_split_small,
    port_small, render_draws,
)

torch.set_num_threads(1)

IMAGES = ("shaded", "geometric_normal", "msdf_image", "alpha", "kd",
          "mesh_id", "diffuse_light", "specular_light", "normal", "depth",
          "invdepth", "ks", "kd_grad", "ks_grad", "normal_grad")


@pytest.fixture(scope="module")
def scene():
    j = jax_split_small()
    p = port_small(j)
    m = j["model"].get_meshes(j["params"]["geometry"], j["params"]["pose"], 0)
    mesh = {k: np.asarray(v) for k, v in dict(
        verts=m.verts_posed, orig=m.verts_template, faces=m.mesh.faces,
        fvalid=m.mesh.face_valid, msdf=m.mesh.msdf_aug).items()}
    # face labels by height, so mesh_id is not constant
    ctr = mesh["orig"][mesh["faces"]].mean(1)[:, 1]
    mesh["labels"] = (ctr > 0).astype(np.int32)
    return j, p, mesh


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _args(mesh, target, conv):
    return ([conv(mesh[k]) for k in ("verts", "orig", "faces", "fvalid")]
            + [target["mvp"], target["campos"]])


def _check_images(got, want, names):
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        if g is None:            # a buffer the port's path does not make
            assert not np.asarray(w).any(), name
            continue
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("layers,bsdf,spp", [
    (1, "kd", 1), (2, "kd", 1), (1, "normal", 1), (2, "normal", 1),
    (1, "kd", 2), (2, "kd", 2), (2, "normal", 2)])
def test_render_mesh_full_matches(scene, layers, bsdf, spp):
    from d3human_tpu.render.pipeline import render_mesh_full as jfull
    from d3human_tpu_torch.render.pipeline import render_mesh_full as tfull

    j, p, mesh = scene
    H, W = j["cfg"].render.train_res
    full = (H * spp, W * spp)
    max_cov = int(full[0] * full[1] * 0.5)
    key = jax.random.PRNGKey(4)
    draws = render_draws(key, (-(-max_cov // 2), 3), (*full, 2))
    kw = dict(spp=spp, max_covered_frac=0.5, bsdf=bsdf, layers=layers)
    # the background is given at the supersampled size
    a = jfull(key, *_args(mesh, j["target"], jnp.asarray), (H, W), j["tex"],
              j["params"]["material"], jnp.full((*full, 3), 0.25),
              msdf_attr=jnp.asarray(mesh["msdf"]),
              face_labels=jnp.asarray(mesh["labels"]),
              raster_opts=JAX_RASTER_OPTS, **kw)
    b = tfull(None, *_args(mesh, p["target"], torch.as_tensor), (H, W),
              p["tex"], p["params"]["material"], torch.full((*full, 3), 0.25),
              msdf_attr=torch.as_tensor(mesh["msdf"]),
              face_labels=torch.as_tensor(mesh["labels"]),
              raster_opts=RASTER_OPTS, draws=draws, **kw)
    assert int((np.asarray(a.rast.tri_id) > 0).sum()) > 50 * spp * spp
    np.testing.assert_array_equal(_np(b.rast.tri_id), np.asarray(a.rast.tri_id))
    np.testing.assert_array_equal(_np(b.rast.zbuf), np.asarray(a.rast.zbuf))
    np.testing.assert_array_equal(_np(b.visible_faces),
                                  np.asarray(a.visible_faces))
    assert b.stats is None and a.stats is None
    assert tuple(b.shaded.shape) == (H, W, 4)
    _check_images(b, a, IMAGES)
    assert float(b.kd_grad[..., :3].abs().max()) > 0     # the jitter ran
    assert float(b.normal_grad[..., :3].abs().max()) > 0


def test_render_mesh_full_dense_texture_and_dispatch(scene):
    """max_covered_frac = 0 samples the texture at every pixel; through
    ``render_mesh`` with compact=False, as validation calls it."""
    from d3human_tpu.render.pipeline import render_mesh as jrender
    from d3human_tpu_torch.render.pipeline import render_mesh as trender

    j, p, mesh = scene
    res = tuple(j["cfg"].render.train_res)
    key = jax.random.PRNGKey(6)
    draws = render_draws(key, (*res, 3), (*res, 2))
    kw = dict(max_covered_frac=0.0, layers=3, compact=False)
    a = jrender(key, *_args(mesh, j["target"], jnp.asarray), res, j["tex"],
                j["params"]["material"], j["target"]["background"],
                raster_opts=JAX_RASTER_OPTS, **kw)
    b = trender(None, *_args(mesh, p["target"], torch.as_tensor), res,
                p["tex"], p["params"]["material"], p["target"]["background"],
                raster_opts=RASTER_OPTS, draws=draws, **kw)
    _check_images(b, a, IMAGES)


def test_render_mesh_full_refuses_what_is_not_ported(scene):
    """A shading the JAX package does not name raises (the
    environment-light shading is ported: ``tests/test_torch_envshade.py``);
    the oracle rasterizer is ported (``tests/test_torch_gt.py`` holds its
    renders to the JAX package's)."""
    from d3human_tpu_torch.render.pipeline import render_mesh_full as tfull

    j, p, mesh = scene
    res = tuple(j["cfg"].render.train_res)
    args = _args(mesh, p["target"], torch.as_tensor) + [
        res, p["tex"], p["params"]["material"], p["target"]["background"]]
    with pytest.raises(NotImplementedError, match="only 'kd'"):
        tfull(None, *args, bsdf="ggx")
    buf = tfull(None, *args, use_bruteforce_raster=True)
    assert int((buf.rast.tri_id > 0).sum()) > 0


@pytest.mark.parametrize("labels,sub,aa_dense", [
    (False, 2, False), (True, 3, False), (False, 2, True)])
def test_render_compact_shaded_matches(scene, labels, sub, aa_dense):
    from d3human_tpu.render.pipeline import render_mesh_compact as jrender
    from d3human_tpu_torch.render.pipeline import render_mesh_compact as trender

    j, p, mesh = scene
    res = tuple(j["cfg"].render.train_res)
    P = int(res[0] * res[1] * 0.5)
    n = -(-P // sub)
    key = jax.random.PRNGKey(8)
    draws = render_draws(key, (n, 3), (n, 2))
    kw = dict(max_covered_frac=0.5, jitter_subsample=sub, aa_dense=aa_dense)
    a = jrender(key, *_args(mesh, j["target"], jnp.asarray), res, j["tex"],
                j["params"]["material"], j["target"]["background"],
                msdf_attr=jnp.asarray(mesh["msdf"]),
                face_labels=jnp.asarray(mesh["labels"]) if labels else None,
                raster_opts=JAX_RASTER_OPTS, **kw)
    b = trender(None, *_args(mesh, p["target"], torch.as_tensor), res,
                p["tex"], p["params"]["material"], p["target"]["background"],
                msdf_attr=torch.as_tensor(mesh["msdf"]),
                face_labels=torch.as_tensor(mesh["labels"]) if labels
                else None, raster_opts=RASTER_OPTS, draws=draws, **kw)
    _check_images(b, a, IMAGES)
    assert b.kd is not None and b.mesh_id is not None
    np.testing.assert_array_equal(_np(b.visible_faces),
                                  np.asarray(a.visible_faces))
    assert set(b.stats) == set(a.stats)
    for k, want in a.stats.items():
        got = b.stats[k]
        if k in ("idx", "valid", "valid_sub", "n_cov", "aa_pairs_x",
                 "aa_pairs_y"):
            np.testing.assert_array_equal(_np(got), np.asarray(want), k)
        elif isinstance(got, torch.Tensor):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                       atol=1e-5, err_msg=k)
        else:
            assert got == want, k
    assert int(b.stats["n_cov"]) > 50
    for k in ("kd_grad", "ks_grad", "nrm_grad"):
        assert float(b.stats[k].abs().max()) > 0, k


def test_draw_shapes_helper_matches_the_render(scene):
    j, _, _ = scene
    (n, _), _ = compact_draw_shapes(j["cfg"])
    H, W = j["cfg"].render.train_res
    assert n == -(-int(H * W * j["cfg"].render.max_covered_frac)
                  // j["cfg"].render.jitter_subsample)


@pytest.mark.parametrize("layers", [1, 2, 3, 4])
def test_validation_render_matches(scene, layers):
    """The validation render of a stage, ``render_stage_mesh(compact=
    False)`` with ``cfg.render.layers``, for both halves of the split."""
    import dataclasses

    from d3human_tpu.train.losses import render_stage_mesh as jstage
    from d3human_tpu_torch.train.losses import render_stage_mesh as tstage

    j, p, _ = scene
    jcfg = dataclasses.replace(j["cfg"], render=dataclasses.replace(
        j["cfg"].render, layers=layers))
    tcfg = dataclasses.replace(p["cfg"], render=dataclasses.replace(
        p["cfg"].render, layers=layers))
    H, W = jcfg.render.train_res
    max_cov = int(H * W * jcfg.render.max_covered_frac)
    key = jax.random.PRNGKey(12)
    draws = render_draws(key, (-(-max_cov // 2), 3), (H, W, 2))
    for sign in (1.0, -1.0):
        _, a = jstage(key, j["model"], j["params"]["geometry"],
                      j["params"]["pose"], j["tex"], j["params"]["material"],
                      j["target"], jcfg, msdf_sign=sign,
                      raster_opts=JAX_RASTER_OPTS, compact=False)
        with torch.no_grad():
            _, b = tstage(None, p["model"], p["params"]["geometry"],
                          p["params"]["pose"], p["tex"],
                          p["params"]["material"], p["target"], tcfg,
                          msdf_sign=sign, raster_opts=RASTER_OPTS,
                          compact=False, draws=draws)
        assert b.stats is None
        assert int(b.alpha.sum()) > 20
        smooth = ("normal", "normal_grad")
        _check_images(b, a, [n for n in IMAGES if n not in smooth])
        # each side renders its OWN extraction here: the posed vertices
        # differ by float32 rounding (4e-7), and a vertex whose faces sum
        # to an area near 1e-5 turns that into 7e-5 of its unit normal, so
        # the two buffers made from the vertex normals get 2e-4. On one
        # shared mesh they agree to 1e-5 too (the tests above).
        for name in smooth:
            np.testing.assert_allclose(
                _np(getattr(b, name)), np.asarray(getattr(a, name)), rtol=0,
                atol=2e-4, err_msg=name)
