"""The texture-bake path of the port against the JAX package on the CPU:
``pipeline/uv_unwrap.py`` bit for bit on the JAX tests' meshes,
``render/texture2d.py`` (mips, sampling, ``render_uv``: masks exact, kd
and ks abs 1e-5), the oracle rasterizer's bounding-box cull (the same ids
and depths as without it, ties included), and
``python -m d3human_tpu_torch.scripts.bake_texture`` on a checkpoint that
the JAX package wrote, against the JAX script (``scripts/
bake_texture.py``) on the same files: the OBJ text equal, the PNGs within
one 8-bit level, the arrays as ``render_uv``'s."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_uv_unwrap import grid_mesh, sphere_mesh

torch.set_num_threads(1)

MESHES = {"grid": lambda: grid_mesh(8),
          "warped": lambda: grid_mesh(10, warp=0.4),
          "sphere": lambda: sphere_mesh(16)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_unwrap_bit_for_bit(mesh):
    from d3human_tpu.pipeline import uv_unwrap as J
    from d3human_tpu_torch.pipeline import uv_unwrap as T

    v, f = MESHES[mesh]()
    for a, b in zip(T.unwrap(v, f), J.unwrap(v, f)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the small charts of a tight angle, and the parts on their own
    for a, b in zip(T.unwrap(v, f, max_angle_deg=20.0, max_chart_faces=30),
                    J.unwrap(v, f, max_angle_deg=20.0, max_chart_faces=30)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(T.grow_charts(v, f, 40.0, 50),
                                  J.grow_charts(v, f, 40.0, 50))
    fl = f[:40]
    vids = np.unique(fl)
    loc = np.searchsorted(vids, fl)
    np.testing.assert_array_equal(T.lscm_chart(v[vids], loc),
                                  J.lscm_chart(v[vids], loc))
    sizes = np.random.default_rng(0).uniform(0.01, 0.3, (25, 2))
    for a, b in zip(T.shelf_pack(sizes), J.shelf_pack(sizes)):
        np.testing.assert_array_equal(a, b)


def test_build_mips_and_texture2d():
    from d3human_tpu.render.texture2d import Texture2D as JT
    from d3human_tpu.render.texture2d import build_mips as jmips
    from d3human_tpu_torch.render.texture2d import Texture2D as TT
    from d3human_tpu_torch.render.texture2d import build_mips as tmips

    rng = np.random.default_rng(1)
    data = rng.uniform(size=(37, 50, 3)).astype(np.float32)
    jm, tm = jmips(jnp.asarray(data)), tmips(torch.as_tensor(data))
    assert len(tm) == len(jm) > 3
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    uv = rng.uniform(-0.1, 1.1, size=(9, 7, 2)).astype(np.float32)
    mm = ([0.1, 0.2, 0.0], [0.9, 0.7, 1.0])
    w = rng.normal(size=(9, 7, 3)).astype(np.float32)
    for min_max in (None, mm):
        for lod in (0.0, 1.3, 2.0, 40.0):
            jt, tt = JT(min_max), TT(min_max)
            jv, jg = jax.value_and_grad(lambda d: jnp.sum(jt.sample(
                {"data": d}, jnp.asarray(uv), lod) * w))(jnp.asarray(data))
            td = torch.tensor(data, requires_grad=True)
            out = tt.sample({"data": td}, torch.as_tensor(uv), lod)
            np.testing.assert_allclose(
                out.detach().numpy(), np.asarray(jt.sample(
                    {"data": jnp.asarray(data)}, jnp.asarray(uv), lod)),
                rtol=0, atol=1e-6, err_msg=f"{min_max} {lod}")
            (out * torch.as_tensor(w)).sum().backward()
            np.testing.assert_allclose(td.grad.numpy(), np.asarray(jg),
                                       rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        TT(mm).clamp({"data": torch.as_tensor(data)})["data"].numpy(),
        np.asarray(JT(mm).clamp({"data": jnp.asarray(data)})["data"]))
    p = TT().init(torch.Generator().manual_seed(0), (8, 4), 2, "cpu")
    assert p["data"].shape == (8, 4, 2)


def _texture(min_max=(np.zeros(6, np.float32), np.ones(6, np.float32))):
    """The JAX package's small texture with signal in its tables, and the
    port's built from the same config: (JAX module, port module, params
    as numpy arrays)."""
    from d3human_tpu.config import TextureConfig
    from d3human_tpu.models.texture import MLPTexture3D
    from d3human_tpu_torch.convert import texture_from_jax_config

    tcfg = TextureConfig(n_levels=2, log2_hashmap_size=10, internal_dims=16)
    jtex = MLPTexture3D(tcfg, tuple(jnp.asarray(a) for a in min_max))
    mat = jtex.init(jax.random.PRNGKey(2))
    mat["encoder"]["table"] = [t * 3e3 for t in mat["encoder"]["table"]]
    return (jtex, texture_from_jax_config(tcfg, min_max, "cpu"),
            jax.tree.map(np.asarray, mat))


@pytest.mark.parametrize("atlas", ["lscm", "grid"])
def test_render_uv_matches(atlas):
    from scripts.bake_texture import grid_atlas

    from d3human_tpu.pipeline.uv_unwrap import unwrap
    from d3human_tpu.render.texture2d import render_uv as jrender
    from d3human_tpu_torch.render.texture2d import render_uv as trender

    v, f = sphere_mesh(12)
    v = (v * 0.4).astype(np.float32)
    f = f.astype(np.int32)
    if atlas == "lscm":
        v_tex, t_idx, _ = unwrap(v, f)
    else:
        v_tex, t_idx = grid_atlas(len(f))
    jtex, ttex, mat = _texture()
    res = (48, 64)
    jm, jkd, jks = jrender(jnp.asarray(v), jnp.asarray(v_tex),
                           jnp.asarray(t_idx), jnp.asarray(f), res, jtex, mat)
    tm, tkd, tks = trender(torch.as_tensor(v), torch.as_tensor(v_tex),
                           torch.as_tensor(t_idx).long(),
                           torch.as_tensor(f).long(), res, ttex,
                           jax.tree.map(torch.tensor, mat))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert 0.2 < float(tm.mean()) < 0.95
    for a, b in ((tkd, jkd), (tks, jks)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    assert float(tkd[tm[..., 0] > 0].std()) > 1e-3      # the tables vary


def _tie_mesh(seed, n_faces=300):
    """Small clip-space triangles (UV-like) in 4 depth planes, every tenth
    one repeated with a higher id (exact ties), a few dead faces."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, (n_faces, 1, 2))
    xy = c + rng.uniform(-0.15, 0.15, (n_faces, 3, 2))
    z = np.repeat(rng.integers(0, 4, (n_faces, 1, 1)) * 0.2 - 0.3, 3, 1)
    clip = np.concatenate([xy, z, np.ones((n_faces, 3, 1))], -1)
    clip = clip.reshape(-1, 4).astype(np.float32)
    faces = np.arange(3 * n_faces, dtype=np.int64).reshape(-1, 3)
    faces = np.concatenate([faces, faces[::10]])
    valid = rng.uniform(size=len(faces)) > 0.05
    return (torch.as_tensor(clip), torch.as_tensor(faces),
            torch.as_tensor(valid))


@pytest.mark.parametrize("chunk", [97, 1000, 1 << 18])
def test_culled_oracle_equals_unculled(chunk):
    from d3human_tpu_torch.ops.rasterizer import rasterize_bruteforce

    clip, faces, valid = _tie_mesh(3)
    res = (40, 64)
    for layers in (1, 3):
        a = rasterize_bruteforce(clip, faces, valid, res, layers=layers,
                                 pixel_chunk=chunk)
        b = rasterize_bruteforce(clip, faces, valid, res, layers=layers,
                                 pixel_chunk=chunk, cull=False)
        a, b = (a, b) if layers > 1 else ((a,), (b,))
        for x, y in zip(a, b):
            assert torch.equal(x.tri_id, y.tri_id)
            assert torch.equal(x.zbuf, y.zbuf)
    ids = a[0].tri_id[a[0].tri_id > 0] - 1
    assert len(ids) > 200 and int((ids >= 300).sum()) == 0  # ties: low id
    assert int((a[1].tri_id > 0).sum()) > 50


def test_bake_entry_point_on_a_jax_checkpoint(tmp_path, capsys):
    """A checkpoint and a mesh written by the JAX package, baked by both
    packages' entry points at 64² with each atlas."""
    import imageio.v2 as imageio
    import scripts.bake_texture as jscript

    from d3human_tpu.config import Config
    from d3human_tpu.models.texture import MLPTexture3D
    from d3human_tpu.render.texture2d import render_uv as jrender
    from d3human_tpu.train.checkpoint import save_params
    from d3human_tpu.utils.io import write_obj
    from d3human_tpu_torch.scripts import bake_texture as tscript
    from d3human_tpu_torch.utils.io import load_image

    cfg = Config()
    r = cfg.render
    tex = MLPTexture3D(cfg.texture, (
        jnp.concatenate([jnp.asarray(r.kd_min[:3]), jnp.asarray(r.ks_min)]),
        jnp.concatenate([jnp.asarray(r.kd_max[:3]), jnp.asarray(r.ks_max)])))
    mat = tex.init(jax.random.PRNGKey(7))
    mat["encoder"]["table"] = [t * 3e3 for t in mat["encoder"]["table"]]
    run = tmp_path / "run"
    save_params(str(run / "init" / "ckp" / "state_5.npz"),
                {"params": {"material": mat}, "step": jnp.int32(5)})
    v, f = sphere_mesh(10)
    mesh = str(tmp_path / "mesh.obj")
    write_obj(mesh, (v * 0.4).astype(np.float32), f)
    for atlas in ("lscm", "grid"):
        argv = ["--run", str(run), "--stage", "init", "--mesh", mesh,
                "--res", "64", "--atlas", atlas]
        jout, tout = tmp_path / f"jax_{atlas}", tmp_path / f"port_{atlas}"
        saved = sys.argv
        sys.argv = ["bake_texture.py", *argv, "--out", str(jout)]
        try:
            jscript.main()
        finally:
            sys.argv = saved
        got = tscript.bake(tscript.parse_args(
            argv + ["--out", str(tout), "--device", "cpu"]))
        with open(jout / "mesh_uv.obj") as a, open(tout / "mesh_uv.obj") as b:
            assert a.read() == b.read()
        for name in ("texture_kd.png", "texture_ks.png"):
            want = imageio.imread(jout / name).astype(np.int16)
            have = load_image(str(tout / name)).astype(np.int16)
            assert want.shape == have.shape
            assert np.abs(want - have).max() <= 1, name
            assert want.max() > 0
        jm, jkd, jks = jrender(
            jnp.asarray(got["verts"]), jnp.asarray(got["v_tex"]),
            jnp.asarray(got["t_tex_idx"]), jnp.asarray(got["faces"]),
            (64, 64), tex, mat)
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(jm))
        np.testing.assert_allclose(got["kd"].numpy(), np.asarray(jkd),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["ks"].numpy(), np.asarray(jks),
                                   rtol=0, atol=1e-5)
    assert "charts" in capsys.readouterr().out


def test_bake_refusals(tmp_path, monkeypatch):
    """xatlas missing, no checkpoint, no card: each ends the run with a
    message, as the JAX script and the port's CLI do."""
    from d3human_tpu.utils.io import write_obj
    from d3human_tpu_torch.scripts import bake_texture as tscript

    v, f = sphere_mesh(6)
    mesh = str(tmp_path / "mesh.obj")
    write_obj(mesh, v.astype(np.float32), f)
    base = ["--run", str(tmp_path), "--mesh", mesh, "--out",
            str(tmp_path / "o"), "--res", "16", "--device", "cpu"]
    if not _has_xatlas():
        with pytest.raises(SystemExit, match="xatlas"):
            tscript.main(base + ["--atlas", "xatlas"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        tscript.main(base + ["--atlas", "grid"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tscript.main(base[:-2])
    assert not os.path.exists(tmp_path / "o")


def _has_xatlas():
    try:
        import xatlas  # noqa: F401
    except ImportError:
        return False
    return True
