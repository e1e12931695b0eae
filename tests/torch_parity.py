"""Shared set-up of the PyTorch-port parity tests: the JAX package's small
scene (``__graft_entry__._small_setup``) and its counterpart in the port,
built from the same numbers (parameters converted, random draws computed
with JAX from the same keys and injected)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

RASTER_OPTS = dict(tile=(8, 16), max_faces_per_tile=128, bin_expand=8,
                   max_global=128)
JAX_RASTER_OPTS = dict(RASTER_OPTS, backend="pallas_interpret")
IT, KEY = 7, 3


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def load_jax_engine():
    """(module, library path): the JAX package's mesh-SDF engine, loaded
    from its committed ``libmeshsdf.so`` as it is. The package's
    ``build_lib`` rebuilds that file in place whenever its mtime is older
    than the source's; loading the library directly never does."""
    from pathlib import Path

    import d3human_tpu.native.meshsdf as J

    lib = Path(J.__file__).with_name("libmeshsdf.so")
    if J._lib is None:
        orig = J.build_lib
        J.build_lib = lambda name, force=False: str(lib)
        try:
            J._load()
        finally:
            J.build_lib = orig
    return J, lib


def jax_small():
    """(cfg, scene, model, perceptual, perc_params, params, target) with
    init_shading off, as the port runs it."""
    from __graft_entry__ import _small_setup

    cfg, scene, model, tex, perceptual, perc_params, params = _small_setup()
    cfg = dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, init_shading=False))
    return dict(cfg=cfg, scene=scene, model=model, tex=tex,
                perceptual=perceptual, perc_params=perc_params,
                params=params, target=scene.frame_target(0))


def jax_split_small():
    """``jax_small`` set up for the split stage: a texture with one dense
    and one hashed level, a perceptual crop smaller than the image, and an
    mSDF field cut at mid height so both halves carry faces."""
    from d3human_tpu.models.texture import MLPTexture3D

    j = jax_small()
    cfg = j["cfg"]
    cfg = dataclasses.replace(
        cfg,
        texture=dataclasses.replace(cfg.texture, log2_hashmap_size=13),
        loss=dataclasses.replace(cfg.loss, perceptual_crop=24))
    tex = MLPTexture3D(cfg.texture, (jnp.zeros((6,)), jnp.ones((6,))))
    assert tex.encoder.dense == (True, False)
    params = dict(j["params"])
    params["material"] = tex.init(jax.random.PRNGKey(11))
    # the reference's table init is ~1e-4, which leaves the albedo flat at
    # 0.5: scale it up so the texture carries signal
    params["material"]["encoder"]["table"] = [
        t * 3e3 for t in params["material"]["encoder"]["table"]]
    params["geometry"] = dict(params["geometry"])
    params["geometry"]["msdf"] = jnp.tanh(
        3.0 * j["model"].grid.verts[:, 1] + 0.2)
    return dict(j, cfg=cfg, tex=tex, params=params)


def port_small(j, device="cpu"):
    """The port's objects holding the same numbers as ``jax_small``."""
    from d3human_tpu_torch.config import from_jax_config
    from d3human_tpu_torch.convert import (
        params_from_jax, perceptual_from_jax, texture_from_jax_config,
    )
    from d3human_tpu_torch.data.synthetic import make_scene
    from d3human_tpu_torch.models.geometry import GeometryModel
    from d3human_tpu_torch.models.perceptual import ConvPerceptual
    from d3human_tpu_torch.ops.tet_grid import make_tet_grid

    cfg = from_jax_config(j["cfg"])
    res = tuple(cfg.render.train_res)
    scene = make_scene(resolution=res, n_frames=j["scene"].n_frames,
                       device=device)
    grid = make_tet_grid(res=cfg.geometry.grid_res,
                         bounds=((-0.6, -0.8, -0.4), (0.6, 0.8, 0.4)),
                         y_offset=0.0, scale=1.0, device=device)
    model = GeometryModel(cfg, grid, scene.deformer, scene.canon)
    perceptual = ConvPerceptual(channels=j["perceptual"].channels)
    target = {k: torch.as_tensor(np.array(v)).to(device)
              for k, v in j["target"].items()}
    target["frame_idx"] = int(j["target"]["frame_idx"])
    tex = texture_from_jax_config(j["cfg"].texture,
                                  to_np(j["tex"].min_max), device)
    return dict(cfg=cfg, scene=scene, model=model, perceptual=perceptual,
                tex=tex,
                perc_params=perceptual_from_jax(to_np(j["perc_params"]),
                                                device),
                params=params_from_jax(to_np(j["params"]), device),
                target=target)


def _key(key):
    """``PRNGKey(key)`` of an int; a key array as it is."""
    return jax.random.PRNGKey(key) if isinstance(key, int) else key


def eik_draws(n, key=KEY):
    """The uniform draws ``tick_init`` makes with ``PRNGKey(key)``
    (losses.py:160 split, mesh_ops.py:165-171)."""
    _, k_sample = jax.random.split(_key(key))
    k1, k2 = jax.random.split(k_sample)
    u = np.array(jax.random.uniform(k1, (n,)))
    uv = np.array(jax.random.uniform(k2, (n, 2)))
    return torch.as_tensor(u), torch.as_tensor(uv)


def _t(a):
    return torch.as_tensor(np.array(a))


def render_draws(k_render, n_tex_shape, n_uv_shape):
    """The standard normals a render draws from ``k_render``
    (pipeline.py:343-371 and :521-565): texture jitter, normal-tap jitter."""
    k_jit, k_nrm = jax.random.split(k_render)
    return (_t(jax.random.normal(k_jit, n_tex_shape)),
            _t(jax.random.normal(k_nrm, n_uv_shape)))


def compact_draw_shapes(cfg):
    """Shapes of the compacted render's two draws for a JAX config."""
    H, W = cfg.render.train_res
    P = int(H * W * cfg.render.max_covered_frac)
    n = -(-P // cfg.render.jitter_subsample)
    return (n, 3), (n, 2)


def init_draws(cfg, key=KEY):
    """All draws of ``tick_init`` with ``PRNGKey(key)`` (losses.py:160)."""
    k_render, _ = jax.random.split(_key(key))
    return {"eik": eik_draws(cfg.geometry.n_eikonal_samples, key),
            "render": render_draws(k_render, *compact_draw_shapes(cfg))}


def split_draws(cfg, key=KEY):
    """All draws of ``tick_split`` with ``PRNGKey(key)``: per half the
    render's normals, the eikonal sampler's uniforms and the crop corner
    (losses.py:219, 348; perceptual.py:212-214)."""
    H, W = cfg.render.train_res
    crop = cfg.loss.perceptual_crop
    out = {}
    halves = jax.random.split(_key(key))
    for name, k in zip(("cloth", "body"), halves):
        k_render, k_sample, k_crop = jax.random.split(k, 3)
        k1, k2 = jax.random.split(k_sample)
        n = cfg.geometry.n_eikonal_samples
        kh, kw = jax.random.split(k_crop)
        out[name] = {
            "render": render_draws(k_render, *compact_draw_shapes(cfg)),
            "eik": (_t(jax.random.uniform(k1, (n,))),
                    _t(jax.random.uniform(k2, (n, 2)))),
            "crop": (int(jax.random.randint(kh, (), 0, max(H - crop, 1))),
                     int(jax.random.randint(kw, (), 0, max(W - crop, 1)))),
        }
    return out


def light_draws(k_render, n):
    """The light sampler's uniforms in a ``bsdf="pbr"`` render from
    ``k_render`` (pipeline.py:611 ``fold_in(key, 17)``, envshade.py:45-47):
    (uy, ux), each [n]."""
    k1, k2 = jax.random.split(jax.random.fold_in(k_render, 17))
    return (_t(jax.random.uniform(k1, (n,))),
            _t(jax.random.uniform(k2, (n,))))
