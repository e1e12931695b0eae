"""The environment-light shading of the port (``render/light.py``'s
sampling tables and lookups, ``render/envshade.py`` and the ``bsdf="pbr"``
branch of ``render_mesh``) against the JAX package, with the JAX
package's random draws injected: values abs 1e-5 (the sampling tables
and the resampled probe 1e-6; the direction lookups differ by the
libraries' arctan2 / arccos, an ulp), gradients of the light and the
texture rel-L2 1e-3."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import (
    JAX_RASTER_OPTS, RASTER_OPTS, light_draws, render_draws,
)

torch.set_num_threads(1)


def _probe(shape=(16, 32), seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.1, 2.0, size=(*shape, 3)).astype(np.float32)


def _dirs(n, seed=1):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    # the poles and the u seam, where the lookup wraps and clamps
    d[:4] = [[0, 1, 0], [0, -1, 0], [0, 0, 1], [1e-3, 0.2, 1]]
    return d


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_update_pdf_sample_latlong_generate_image():
    from d3human_tpu.render import light as jl
    from d3human_tpu_torch.render import light as tl

    base = _probe()
    jt = jl.update_pdf({"base": jnp.asarray(base)})
    tb = torch.tensor(base, requires_grad=True)
    tt = tl.update_pdf({"base": tb})
    for k in ("pdf", "rows", "cols"):
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert not tt["pdf"].requires_grad          # the probe is detached

    dirs = _dirs(200)
    w = np.random.default_rng(2).normal(size=(200, 3)).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda b: jnp.sum(
        jl.sample_latlong({"base": b}, jnp.asarray(dirs)) * w))(
        jnp.asarray(base))
    tv = (tl.sample_latlong({"base": tb}, torch.as_tensor(dirs))
          * torch.as_tensor(w)).sum()
    tv.backward()
    assert abs(float(tv.detach()) - float(jv)) <= 1e-4 * abs(float(jv))
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(
        tl.sample_latlong({"base": torch.as_tensor(base)},
                          torch.as_tensor(dirs)).numpy(),
        np.asarray(jl.sample_latlong({"base": jnp.asarray(base)},
                                     jnp.asarray(dirs))), rtol=0, atol=1e-5)
    for res in ((8, 8), (40, 24)):
        np.testing.assert_allclose(
            tl.generate_image({"base": torch.as_tensor(base)}, res).numpy(),
            np.asarray(jl.generate_image({"base": jnp.asarray(base)}, res)),
            rtol=0, atol=1e-6, err_msg=str(res))


def test_sample_light_dirs_with_jax_draws():
    from d3human_tpu.render import envshade as je
    from d3human_tpu.render import light as jl
    from d3human_tpu_torch.render import envshade as te
    from d3human_tpu_torch.render import light as tl

    base = _probe(seed=3)
    key = jax.random.PRNGKey(5)
    n = 64
    jd, jr, jp = je.sample_light_dirs(
        key, {"base": jnp.asarray(base)},
        jl.update_pdf({"base": jnp.asarray(base)}), n)
    k1, k2 = jax.random.split(key)
    draws = (torch.as_tensor(np.array(jax.random.uniform(k1, (n,)))),
             torch.as_tensor(np.array(jax.random.uniform(k2, (n,)))))
    tb = {"base": torch.as_tensor(base)}
    td, tr, tp = te.sample_light_dirs(None, tb, tl.update_pdf(tb), n, draws)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)
    # the samples follow the probe: a bright texel draws most of them
    hot = np.full((16, 32, 3), 0.01, np.float32)
    hot[5, 20] = 100.0
    hb = {"base": torch.as_tensor(hot)}
    d, _, _ = te.sample_light_dirs(torch.Generator().manual_seed(0), hb,
                                   tl.update_pdf(hb), 256)
    want = te._dir_from_latlong(torch.tensor(20.5 / 32),
                                torch.tensor(5.5 / 16))
    assert float(((d - want).norm(dim=-1) < 1e-5).float().mean()) > 0.9


def test_ggx_specular():
    from d3human_tpu.render.envshade import ggx_specular as jg
    from d3human_tpu_torch.render.envshade import ggx_specular as tg

    rng = np.random.default_rng(4)

    def unit(k):
        x = rng.normal(size=(k, 3)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    n, v, l = unit(300), unit(300), unit(300)
    rough = rng.uniform(0.0, 1.0, size=(300, 1)).astype(np.float32)
    want = np.asarray(jg(*(jnp.asarray(a) for a in (n, v, l, rough))))
    got = tg(*(torch.as_tensor(a) for a in (n, v, l, rough))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert want.max() > 0.5          # sharp lobes are reached


def _blocker(xp):
    c = xp.asarray([0.0, 0.6, 0.0])
    if xp is torch:
        return lambda p: 0.3 - (p - c).norm(dim=-1)
    return lambda p: 0.3 - jnp.linalg.norm(p - c, axis=-1)


def test_sphere_trace_shadow_on_the_blocker_sphere():
    """The JAX test's blocker sphere above the origin, then rays from a
    grid of origins in random directions."""
    from d3human_tpu.render.envshade import sphere_trace_shadow as js
    from d3human_tpu_torch.render.envshade import sphere_trace_shadow as ts

    up = ts(_blocker(torch), torch.zeros((1, 3)),
            torch.tensor([[0.0, 1.0, 0.0]]))
    down = ts(_blocker(torch), torch.zeros((1, 3)),
              torch.tensor([[0.0, -1.0, 0.0]]))
    assert float(up[0]) < 0.1 and float(down[0]) > 0.9
    rng = np.random.default_rng(6)
    o = rng.uniform(-0.5, 0.5, size=(8, 16, 3)).astype(np.float32)
    d = rng.normal(size=(8, 16, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = np.asarray(js(_blocker(jnp), jnp.asarray(o), jnp.asarray(d)))
    got = ts(_blocker(torch), torch.as_tensor(o), torch.as_tensor(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert want.min() < 0.1 and want.max() > 0.9


@pytest.mark.parametrize("shadow", [False, True])
def test_env_shade(shadow):
    from d3human_tpu.render.envshade import env_shade as je
    from d3human_tpu_torch.render.envshade import env_shade as te

    rng = np.random.default_rng(7)
    shape = (6, 10)
    pos = rng.uniform(-0.4, 0.4, size=(*shape, 3)).astype(np.float32)
    nrm = rng.normal(size=(*shape, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    kd = rng.uniform(size=(*shape, 3)).astype(np.float32)
    ks = rng.uniform(size=(*shape, 3)).astype(np.float32)
    cam = np.asarray([0.3, 0.2, 2.5], np.float32)
    base = _probe(seed=8)
    key = jax.random.PRNGKey(9)
    n = 12
    jd, jsp = je(key, *(jnp.asarray(a) for a in (pos, nrm, cam, kd, ks)),
                 {"base": jnp.asarray(base)}, n_samples=n,
                 sdf_fn=_blocker(jnp) if shadow else None, shadow_scale=0.7)
    k1, k2 = jax.random.split(key)
    draws = (torch.as_tensor(np.array(jax.random.uniform(k1, (n,)))),
             torch.as_tensor(np.array(jax.random.uniform(k2, (n,)))))
    td, tsp = te(None, *(torch.as_tensor(a) for a in (pos, nrm, cam, kd, ks)),
                 {"base": torch.as_tensor(base)}, n_samples=n,
                 sdf_fn=_blocker(torch) if shadow else None,
                 shadow_scale=0.7, draws=draws)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tsp.numpy(), np.asarray(jsp), rtol=1e-5,
                               atol=1e-5)
    assert float(td.max()) > 0 and float(tsp.max()) > 0


# ------------------------------------------------------------ the render

@pytest.fixture(scope="module")
def scene():
    """A sphere of 512 faces before a camera at 32² pixels, and a texture
    with one dense and one hashed level whose tables carry signal; the
    same numbers on both sides."""
    from d3human_tpu.config import TextureConfig
    from d3human_tpu.models.texture import MLPTexture3D
    from d3human_tpu.render.camera import look_at, perspective
    from d3human_tpu_torch.convert import texture_from_jax_config
    from test_pipeline import icosphere

    v, f = icosphere(radius=0.5, n=3)
    # a bump, so the normals and the shadows vary
    v = (v * (1.0 + 0.2 * np.sin(4.0 * v[:, :1]))).astype(np.float32)
    mvp = (perspective(0.9, 1.0, 0.1, 100.0)
           @ look_at((0.4, 0.3, 2.0), (0.0, 0.0, 0.0))).astype(np.float32)
    tcfg = TextureConfig(n_levels=2, log2_hashmap_size=10, internal_dims=16)
    mm = (np.zeros(6, np.float32), np.ones(6, np.float32))
    jtex = MLPTexture3D(tcfg, tuple(jnp.asarray(a) for a in mm))
    mat = jtex.init(jax.random.PRNGKey(11))
    mat["encoder"]["table"] = [t * 3e3 for t in mat["encoder"]["table"]]
    mesh = dict(verts=v, orig=v, faces=f.astype(np.int32),
                fvalid=np.ones(len(f), bool), mvp=mvp,
                campos=np.asarray([0.4, 0.3, 2.0], np.float32))
    return dict(mesh=mesh, res=(32, 32), jtex=jtex,
                ttex=texture_from_jax_config(tcfg, mm, "cpu"),
                mat=jax.tree.map(np.asarray, mat))


PBR_IMAGES = ("shaded", "diffuse_light", "specular_light", "kd", "ks",
              "normal", "geometric_normal", "depth", "alpha")
N_LIGHT = 6


def _args(sc, conv):
    m = sc["mesh"]
    return [conv(m[k]) for k in ("verts", "orig", "faces", "fvalid", "mvp",
                                 "campos")] + [sc["res"]]


def _pbr_pair(sc, key, shadow, spp=1, layers=1):
    """(JAX buffers, port buffers, JAX grads, the port's leaves) of one pbr
    render and the gradient of a fixed random projection of its shaded
    and light buffers with respect to the light and the texture."""
    from d3human_tpu.render.pipeline import render_mesh as jrender
    from d3human_tpu_torch.render.pipeline import render_mesh as trender

    H, W = sc["res"]
    full = (H * spp, W * spp)
    max_cov = int(full[0] * full[1] * 0.5)
    base = _probe(seed=10)
    # the buffers come back at (H, W) whatever the supersampling
    wts = np.random.default_rng(11).normal(size=(H, W, 10)).astype(
        np.float32)
    kw = dict(spp=spp, layers=layers, max_covered_frac=0.5, bsdf="pbr",
              n_light_samples=N_LIGHT, shadow_scale=0.8)
    jsdf = _blocker(jnp) if shadow else None

    def jloss(light, mat):
        b = jrender(key, *_args(sc, jnp.asarray), sc["jtex"], mat,
                    jnp.full((*full, 3), 0.25), raster_opts=JAX_RASTER_OPTS,
                    light_params=light, sdf_fn=jsdf, **kw)
        proj = jnp.concatenate([b.shaded, b.diffuse_light,
                                b.specular_light], -1)
        return jnp.sum(proj * wts), b

    (_, jb), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True))(
        {"base": jnp.asarray(base)}, sc["mat"])
    light = {"base": torch.tensor(base, requires_grad=True)}
    mat = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True),
                       sc["mat"])
    draws = render_draws(key, (-(-max_cov // 2), 3), (*full, 2)) + (
        light_draws(key, N_LIGHT),)
    tb = trender(None, *_args(sc, torch.as_tensor), sc["ttex"], mat,
                 torch.full((*full, 3), 0.25), raster_opts=RASTER_OPTS,
                 light_params=light, sdf_fn=_blocker(torch) if shadow
                 else None, draws=draws, **kw)
    (torch.cat([tb.shaded, tb.diffuse_light, tb.specular_light], -1)
     * torch.as_tensor(wts)).sum().backward()
    return jb, tb, jg, (light, mat)


@pytest.mark.parametrize("shadow,spp,layers", [
    (False, 1, 1), (True, 1, 1), (False, 2, 2)])
def test_render_mesh_pbr_matches(scene, shadow, spp, layers):
    jb, tb, (jgl, jgm), (light, mat) = _pbr_pair(
        scene, jax.random.PRNGKey(13), shadow, spp, layers)
    assert int((np.asarray(jb.rast.tri_id) > 0).sum()) > 100 * spp * spp
    for name in PBR_IMAGES:
        np.testing.assert_allclose(getattr(tb, name).detach().numpy(),
                                   np.asarray(getattr(jb, name)), rtol=0,
                                   atol=1e-5, err_msg=name)
    assert float(tb.specular_light.detach().abs().max()) > 0
    assert float(tb.diffuse_light.detach().abs().max()) > 0
    assert _rel(light["base"].grad.numpy(), jgl["base"]) < 1e-3
    jleaves = jax.tree.leaves(jgm)
    tleaves = jax.tree.leaves(mat)
    assert len(jleaves) == len(tleaves)
    for tg, jg in zip(tleaves, jleaves):
        jg = np.asarray(jg)
        if np.linalg.norm(jg) == 0:
            assert float(tg.grad.abs().max()) == 0
        else:
            assert _rel(tg.grad.numpy(), jg) < 1e-3
    assert float(light["base"].grad.abs().max()) > 0


def test_pbr_without_a_light_renders_kd(scene):
    """As in the JAX package: ``bsdf="pbr"`` and no ``light_params`` shade
    with the albedo; names other than kd, normal and pbr raise."""
    from d3human_tpu_torch.render.pipeline import render_mesh

    args = _args(scene, torch.as_tensor) + [
        scene["ttex"], jax.tree.map(torch.tensor, scene["mat"]),
        torch.full((*scene["res"], 3), 0.25)]
    kw = dict(raster_opts=RASTER_OPTS, max_covered_frac=0.5)
    pbr = render_mesh(torch.Generator().manual_seed(0), *args, bsdf="pbr",
                      **kw)
    kd = render_mesh(torch.Generator().manual_seed(0), *args, compact=False,
                     **kw)
    assert pbr.stats is None                    # never the compacted path
    torch.testing.assert_close(pbr.shaded, kd.shaded, rtol=0, atol=0)
    assert float(pbr.diffuse_light.abs().max()) == 0
    with pytest.raises(NotImplementedError, match="only 'kd'"):
        render_mesh(None, *args, bsdf="ggx", **kw)
