"""The port's synthetic ground truth against the JAX package on the CPU:
the oracle rasterizer (layers 1 and 3, a random mesh and the synthetic
body; ids exact, depths abs 1e-6; the same answer for two pixel chunks),
the full render through it, ``frame_target`` of every frame of a 4-frame
capture (buffers abs 1e-5, alpha exact), ``CachedTargets`` (the fp16 pack
exact, the rebuilt targets abs 1e-6) and the training frame order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import jax_split_small, port_small, render_draws

torch.set_num_threads(1)

BUFFERS = ("all_img", "cloth_img", "body_img", "all_normal", "cloth_normal",
           "body_normal", "background", "mvp", "mv", "campos")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _random_mesh(seed=0, n_faces=60):
    """Overlapping triangles in front of the camera (clip space), some of
    them sharing edges, with a few dead faces."""
    rng = np.random.default_rng(seed)
    V = 3 * n_faces // 2
    xy = rng.uniform(-1.1, 1.1, (V, 2))
    w = rng.uniform(0.8, 1.5, (V, 1))
    z = rng.uniform(-0.9, 0.9, (V, 1))
    clip = np.concatenate([xy * w, z * w, w], 1).astype(np.float32)
    faces = rng.integers(0, V, (n_faces, 3)).astype(np.int32)
    valid = rng.uniform(size=n_faces) > 0.1
    return clip, faces, valid


def _body_clip(res):
    from d3human_tpu.data.synthetic import make_scene
    from d3human_tpu.ops.rasterizer import xfm_points

    sc = make_scene(resolution=res, n_frames=4)
    pp = sc.pose_params
    v, _, _ = sc.model.forward(
        betas=pp["shape"], root_pose=pp["root_pose"][1:2],
        body_pose=pp["body_pose"][1:2], transl=pp["trans"][1:2])
    f = np.asarray(sc.model.faces, np.int32)
    return (np.asarray(xfm_points(v[0], sc.mvp)), f,
            np.ones((f.shape[0],), bool))


MESHES = {"random": lambda: _random_mesh(),
          "body": lambda: _body_clip((96, 96))}


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rasterize_bruteforce_matches(mesh, layers):
    from d3human_tpu.ops.rasterizer import rasterize_bruteforce as jrb
    from d3human_tpu_torch.ops.rasterizer import rasterize_bruteforce as trb

    clip, faces, valid = MESHES[mesh]()
    res = (96, 96) if mesh == "body" else (40, 56)
    a = jrb(jnp.asarray(clip), jnp.asarray(faces), jnp.asarray(valid), res,
            layers=layers)
    b = trb(torch.as_tensor(clip), torch.as_tensor(faces),
            torch.as_tensor(valid), res, layers=layers)
    a, b = (a, b) if layers > 1 else ((a,), (b,))
    assert len(b) == layers
    assert int((np.asarray(a[0].tri_id) > 0).sum()) > 150
    for ja, tb in zip(a, b):
        np.testing.assert_array_equal(_np(tb.tri_id), np.asarray(ja.tri_id))
        np.testing.assert_allclose(_np(tb.zbuf), np.asarray(ja.zbuf),
                                   rtol=0, atol=1e-6)
    if mesh == "random":           # the peel reaches a third layer
        assert int((_np(b[-1].tri_id) > 0).sum()) > 0


def test_rasterize_bruteforce_chunking_invariant():
    from d3human_tpu_torch.ops.rasterizer import rasterize_bruteforce as trb

    clip, faces, valid = (torch.as_tensor(x) for x in _random_mesh(1, 80))
    one = trb(clip, faces, valid, (40, 56), layers=2, pixel_chunk=40 * 56)
    many = trb(clip, faces, valid, (40, 56), layers=2, pixel_chunk=333)
    for x, y in zip(one, many):
        assert torch.equal(x.tri_id, y.tri_id)
        assert torch.equal(x.zbuf, y.zbuf)


@pytest.mark.parametrize("layers", [1, 2])
def test_render_mesh_bruteforce_matches(layers):
    """``render_mesh(use_bruteforce_raster=True)`` goes down the full path
    with the oracle's visibility, as the JAX package's does."""
    from d3human_tpu.render.pipeline import render_mesh as jrender
    from d3human_tpu_torch.render.pipeline import render_mesh as trender

    j = jax_split_small()
    p = port_small(j)
    m = j["model"].get_meshes(j["params"]["geometry"], j["params"]["pose"], 0)
    mesh = [np.asarray(x) for x in (m.verts_posed, m.verts_template,
                                    m.mesh.faces, m.mesh.face_valid)]
    res = tuple(j["cfg"].render.train_res)
    key = jax.random.PRNGKey(5)
    P = int(res[0] * res[1] * 0.5)
    draws = render_draws(key, (-(-P // 2), 3), (*res, 2))
    kw = dict(use_bruteforce_raster=True, layers=layers, compact=False)
    a = jrender(key, *map(jnp.asarray, mesh), j["target"]["mvp"],
                j["target"]["campos"], res, j["tex"],
                j["params"]["material"], j["target"]["background"],
                msdf_attr=m.mesh.msdf_aug, **kw)
    b = trender(None, *map(torch.as_tensor, mesh), p["target"]["mvp"],
                p["target"]["campos"], res, p["tex"],
                p["params"]["material"], p["target"]["background"],
                msdf_attr=torch.as_tensor(np.asarray(m.mesh.msdf_aug)),
                draws=draws, **kw)
    assert int((np.asarray(a.rast.tri_id) > 0).sum()) > 50
    np.testing.assert_array_equal(_np(b.rast.tri_id),
                                  np.asarray(a.rast.tri_id))
    for name in ("shaded", "geometric_normal", "msdf_image", "alpha",
                 "normal", "depth", "kd"):
        np.testing.assert_allclose(_np(getattr(b, name)),
                                   np.asarray(getattr(a, name)), rtol=0,
                                   atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def scenes():
    from d3human_tpu.data.synthetic import make_scene as jscene
    from d3human_tpu_torch.data.synthetic import make_scene as tscene

    return (jscene(resolution=(64, 64), n_frames=4),
            tscene(resolution=(64, 64), n_frames=4, device="cpu"))


def test_frame_target_matches(scenes):
    js, ts = scenes
    for it in range(6):            # the frame index wraps at n_frames
        a, b = js.frame_target(it), ts.frame_target(it)
        assert set(b) == set(a)
        assert b["frame_idx"] == int(a["frame_idx"]) == it % 4
        for k in BUFFERS:
            np.testing.assert_allclose(_np(b[k]), np.asarray(a[k]), rtol=0,
                                       atol=1e-5, err_msg=f"{it} {k}")
        np.testing.assert_array_equal(_np(b["all_img"][..., 3]),
                                      np.asarray(a["all_img"][..., 3]))
        assert int(_np(b["all_img"][..., 3]).sum()) > 100
        assert _np(b["cloth_img"][..., 3]).sum() > 0
        assert _np(b["body_img"][..., 3]).sum() > 0


def test_cached_targets_match(scenes):
    """The pack and the rebuild are exact on the same float32 targets (the
    port's frames through JAX's ``_pack_frame`` and the port's
    ``pack_target``; the JAX cache through the port's rebuild). Each
    package's own cache is within one fp16 step of the other's: the
    float32 targets that each packs differ by ulps (XLA fuses the JAX
    pack's render, so even the JAX cache and the JAX ``frame_target``
    differ so), which moves a value near a rounding boundary by one fp16
    step (2^-11 below 1)."""
    import types

    from d3human_tpu.data.synthetic import CachedTargets as JC
    from d3human_tpu_torch.data.synthetic import CachedTargets as TC
    from d3human_tpu_torch.data.synthetic import pack_target

    js, ts = scenes
    a, b = JC(js), TC(ts)
    assert b._cache.dtype == torch.float16
    for i in range(4):
        tt = ts._frame_target_impl(i)
        stub = types.SimpleNamespace(scene=types.SimpleNamespace(
            _frame_target_impl=lambda _, tt=tt: {
                k: jnp.asarray(_np(v)) for k, v in tt.items()
                if isinstance(v, torch.Tensor)}))
        np.testing.assert_array_equal(
            _np(pack_target(tt)), np.asarray(JC._pack_frame(stub, i)))
    ours = _np(b._cache).astype(np.float32)
    theirs = np.asarray(a._cache).astype(np.float32)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=2.0 ** -11)
    assert (ours != theirs).mean() < 1e-3
    b._cache = torch.as_tensor(np.array(a._cache))
    for it in (0, 3, 5):
        ta, tb = a.frame_target(it), b.frame_target(it)
        assert tb["frame_idx"] == int(ta["frame_idx"]) == it % 4
        for k in BUFFERS:
            np.testing.assert_allclose(_np(tb[k]), np.asarray(ta[k]), rtol=0,
                                       atol=1e-6, err_msg=f"{it} {k}")


def test_shuffled_indexer_matches():
    from d3human_tpu.data.dataset import shuffled_indexer as J
    from d3human_tpu_torch.data.dataset import shuffled_indexer as T

    for n, seed in ((7, 0), (4, 3)):
        a, b = J(n, seed=seed), T(n, seed=seed)
        order = [b(it) for it in range(3 * n)]
        assert order == [a(it) for it in range(3 * n)]
        for ep in range(3):
            assert sorted(order[ep * n:(ep + 1) * n]) == list(range(n))
        assert order[:n] != order[n:2 * n] or order[n:2 * n] != order[2 * n:]
