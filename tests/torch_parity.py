"""Shared set-up of the PyTorch-port parity tests: the JAX package's small
scene (``__graft_entry__._small_setup``) and its counterpart in the port,
built from the same numbers (parameters converted, random draws computed
with JAX from the same keys and injected)."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

# the port's rasterizer has no capacity; the JAX side's cuts nothing in
# these scenes (the small scene's longest tile list is 705 faces, its
# oversize faces none)
RASTER_OPTS = dict(tile=(8, 16), bin_expand=8)
JAX_RASTER_OPTS = dict(RASTER_OPTS, max_faces_per_tile=768, max_global=128,
                       backend="pallas_interpret")
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


# ---------------------------------------------------------------- the bench

BENCH_SEED_STEPS = "10"      # capsule-seed steps of the bench tests' builds
# the optimizer count of the bench's first timed step (after its default
# BENCH_WARMUP=3 warm-up steps): lr 3/300 of its peak
BENCH_COUNT = 3


def bench_env(mp, **env):
    """``mp`` (a ``pytest.MonkeyPatch``) set up for a bench build: every
    BENCH_* variable unset, the JAX bench on the CPU, a capsule seed of
    BENCH_SEED_STEPS steps, then ``env``."""
    import os

    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        mp.delenv(k)
    mp.setenv("D3H_PLATFORM", "cpu")
    mp.setenv("BENCH_SDF_SEED_STEPS", BENCH_SEED_STEPS)
    for k, v in env.items():
        mp.setenv(k, v)


def jax_bench():
    """The repository's ``bench.py``, imported as it is."""
    import importlib

    return importlib.import_module("bench")


def jax_state_at(state, n):
    """A JAX bench ``TrainState`` with its step and every optimizer count
    (each integer scalar of the optax state) set to ``n``."""
    opt = jax.tree.map(
        lambda x: jnp.full_like(x, n)
        if jnp.issubdtype(x.dtype, jnp.integer) and x.ndim == 0 else x,
        state.opt_state)
    return state._replace(opt_state=opt,
                          step=jnp.asarray(n, jnp.asarray(state.step).dtype))


def port_state_from_jax(stage, jstate, jextras, pextras, n):
    """The port's bench state holding the JAX bench state's parameters
    (``convert.py``), its optimizer count and step set to ``n``; the port's
    perceptual parameters replaced in place by the JAX bench's, so the
    port's step function sees them."""
    from d3human_tpu_torch.convert import params_from_jax, perceptual_from_jax
    from d3human_tpu_torch.train.step import init_state

    perc = to_np(jextras["perc_params"])
    pextras["perc_params"].clear()
    pextras["perc_params"].update(
        perceptual_from_jax(perc, "cpu") if "ws" in perc else perc)
    state = init_state(stage, params_from_jax(to_np(jstate.params), "cpu"),
                       pextras["cfg"])
    state.opt.count = state.step = n
    return state


def bench_key():
    """The JAX bench's key of its first timed step."""
    return jax.random.fold_in(jax.random.PRNGKey(42), 100)


def build_both(tmp, **env):
    """(JAX bench build, port bench build, {package: capsule target}) of
    ``build("small")`` under the BENCH_* variables ``env``."""
    import pytest

    from d3human_tpu.models.geometry import GeometryModel as JModel
    from d3human_tpu_torch import bench as pbench
    from d3human_tpu_torch.models.geometry import GeometryModel as PModel

    targets = {}

    def recording(name, orig):
        def pretrain_sdf(self, params, target, *a, **kw):
            targets[name] = np.array(target)
            return orig(self, params, target, *a, **kw)
        return pretrain_sdf

    jbench = jax_bench()
    with pytest.MonkeyPatch.context() as mp:
        bench_env(mp, **env)
        # the JAX bench caches its lattice under REPO/.tet_cache: a
        # directory of this test's own, so no other test reads a half
        # written file
        mp.setattr(jbench, "REPO", str(tmp))
        mp.setattr(JModel, "pretrain_sdf",
                   recording("jax", JModel.pretrain_sdf))
        mp.setattr(PModel, "pretrain_sdf",
                   recording("port", PModel.pretrain_sdf))
        j = jbench.build("small")
        p = pbench.build("small", "cpu", cache_dir=str(tmp))
    return j, p, targets


BENCH_EXACT = ("n_cross", "n_valid_tets", "n_big_faces", "n_max_tile")


def port_cfg_of(jcfg):
    """The port's ``Config`` a JAX bench config should build: field by
    field, but for the one field that names each package's own npz."""
    from d3human_tpu_torch.config import LossConfig, from_jax_config

    want = from_jax_config(jcfg)
    return dataclasses.replace(want, loss=dataclasses.replace(
        want.loss, perceptual_npz=LossConfig().perceptual_npz))


def to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def bench_scalars(metrics):
    return {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def compare_scalars(got: dict, want: dict) -> None:
    """Counters exact, every other scalar rel 5e-3."""
    import pytest

    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith(BENCH_EXACT):
            assert got[k] == w, (k, got[k], w)
        else:
            assert got[k] == pytest.approx(w, rel=5e-3, abs=1e-5), \
                (k, got[k], w)


def jax_first_moments(opt_state) -> dict:
    """{path: Adam's first moment} of a JAX bench optimizer state, by the
    port's leaf paths (each leaf lives in one group's inner state)."""
    out = {}
    for path, x in jax.tree_util.tree_leaves_with_path(opt_state):
        ks = jax.tree_util.keystr(path)
        if ".mu" in ks:
            tail = ks.split(".mu", 1)[1]
            out["/".join(re.findall(r"\['?([^\]']+)'?\]", tail))] = \
                np.asarray(x)
    return out


def compare_step(state, before: dict, jnew, grad_tol=None,
                 noise=()) -> set:
    """The port's state after one step against the JAX bench's: every
    parameter within rel-L2 1e-4 and, with ``grad_tol``, every leaf's
    first Adam moment (0.1 x its gradient) within rel-L2 ``grad_tol``.
    The leaves under a prefix in ``noise``, whose gradient is float32
    noise, are only held finite.

    A leaf that was all zeros before the step (the deformation, pose
    leaves) is its own update: Adam's first step moves each element by a
    constant times lr x sign(g), unless |g| is near Adam's eps, where
    float32 noise in g moves the update by as much as the update itself.
    Such a leaf is held element by element (rel 1e-4) where its JAX
    gradient stands above 1e-3 of its largest and the two gradients agree
    in sign; at most 0.1 % of those elements may disagree in sign.
    Returns the leaves' groups that moved."""
    from d3human_tpu_torch.train.optim import named_leaves

    want = {k: v.numpy() for k, v in named_leaves(
        jax.tree.map(lambda a: torch.as_tensor(np.array(a)), jnew.params))}
    mu = jax_first_moments(jnew.opt_state)
    got = dict(named_leaves(state.params))
    assert set(got) == set(want)
    assert set(state.opt.mu) <= set(mu) and len(state.opt.mu) > 10
    for k, m in state.opt.mu.items():
        if grad_tol is not None and np.linalg.norm(mu[k]) > 0:
            assert rel_l2(m.numpy(), mu[k]) <= grad_tol, \
                (k, rel_l2(m.numpy(), mu[k]))
    moved = set()
    for k, t in got.items():
        if not t.is_floating_point():
            continue
        t, w = t.numpy(), want[k]
        if not np.array_equal(t, before[k].numpy()):
            moved.add(k.split("/")[1] if k.startswith("geometry")
                      else k.split("/")[0])
        if k.startswith(noise):
            assert np.isfinite(t).all(), k
        elif np.linalg.norm(w) == 0:
            assert np.linalg.norm(t) == 0, k
        elif not before[k].any() and k in mu:
            big = np.abs(mu[k]) > 1e-3 * np.abs(mu[k]).max()
            same = np.sign(state.opt.mu[k].numpy()) == np.sign(mu[k])
            assert (big & ~same).sum() <= 1e-3 * big.sum(), \
                (k, (big & ~same).sum(), big.sum())
            np.testing.assert_allclose(t[big & same], w[big & same],
                                       rtol=1e-4, atol=1e-7, err_msg=k)
        else:
            assert rel_l2(t, w) <= 1e-4, (k, rel_l2(t, w))
    return moved
