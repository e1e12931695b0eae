"""The port's driver modules against the JAX package on the CPU: the
config loader on every shipped config, PNG images, npz checkpoints read
across the two packages, the port's own state round trip, the cache and
checkpoint file names, the metrics, the weight-free perceptual losses, the
three validations and the seq stage's visible-triangle sets."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import (
    JAX_RASTER_OPTS, RASTER_OPTS, jax_split_small, port_small, to_np,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.json")))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-30))


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_configs_load_as_in_jax(path):
    import d3human_tpu.config as J
    import d3human_tpu_torch.config as T

    over = {"out_dir": "somewhere", "gender": "female"}
    j, t = J.load_config(path, over), T.load_config(path, over)
    # the one default of the port's own: the MobileNet weights live in its
    # own data directory (the same file layout)
    assert t.loss.perceptual_npz == j.loss.perceptual_npz.replace(
        "d3human_tpu/data/", "d3human_tpu_torch/data/")
    t_as_jax = t.replace(loss=dataclasses.replace(
        t.loss, perceptual_npz=j.loss.perceptual_npz))
    for f in dataclasses.fields(t):
        got, want = getattr(t_as_jax, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(got):
            for g in dataclasses.fields(got):
                assert getattr(got, g.name) == getattr(want, g.name), \
                    (f.name, g.name)
        else:
            assert got == want, f.name
    assert T.from_jax_config(j) == t_as_jax
    assert t.out_dir == "somewhere" and t.gender == "female"
    # the port's tree has every field of the JAX one, section by section
    names = {f.name for f in dataclasses.fields(j)}
    assert {f.name for f in dataclasses.fields(t)} == names
    for name in names:
        if dataclasses.is_dataclass(getattr(j, name)):
            assert ({f.name for f in dataclasses.fields(getattr(t, name))}
                    == {f.name for f in dataclasses.fields(getattr(j, name))}
                    ), name


# ---------------------------------------------------------------- files

@pytest.mark.parametrize("shape", [(9, 13, 3), (6, 5), (7, 4, 1), (5, 8, 4)])
def test_save_image_decodes_as_jax_writes(tmp_path, shape):
    import imageio.v2 as imageio

    from d3human_tpu.utils.io import save_image as jsave
    from d3human_tpu_torch.utils.io import save_image as tsave

    img = np.random.default_rng(len(shape)).uniform(-0.3, 1.3, shape)
    img = img.astype(np.float32)
    tsave(str(tmp_path / "port" / "a.png"), torch.as_tensor(img))
    got = imageio.imread(str(tmp_path / "port" / "a.png"))
    if shape[-1] != 1:
        jsave(str(tmp_path / "jax.png"), img)
        np.testing.assert_array_equal(got, imageio.imread(
            str(tmp_path / "jax.png")))
    np.testing.assert_array_equal(
        got, np.clip(img * 255, 0, 255).astype(np.uint8).reshape(got.shape))


@pytest.fixture(scope="module")
def small():
    j = jax_split_small()
    return j, port_small(j)


def _flat_np(tree):
    from d3human_tpu_torch.train.optim import named_leaves

    return {k: _np(v) for k, v in named_leaves(tree)}


def _perturbed(p):
    """The port's tree with every floating leaf moved, so a load that
    reads nothing would show."""
    from d3human_tpu_torch.train.optim import named_leaves

    out = _clone(p)
    for _, leaf in named_leaves(out):
        if leaf.is_floating_point():
            leaf.add_(1.0)
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def test_npz_params_cross_between_packages(small, tmp_path):
    """JAX's file read by the port, the port's read by JAX, and a JAX
    state file's params read by the port: equal leaves. A leaf of another
    shape in the file keeps the template's value."""
    from d3human_tpu.train import checkpoint as J
    from d3human_tpu_torch.train import checkpoint as T

    j, p = small
    want = _flat_np(p["params"])
    J.save_params(str(tmp_path / "jax.npz"), j["params"])
    got = T.load_params(str(tmp_path / "jax.npz"), _perturbed(p["params"]))
    assert _flat_np(got).keys() == want.keys()
    for k, v in _flat_np(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)

    T.save_params(str(tmp_path / "port.npz"), p["params"])
    with np.load(str(tmp_path / "port.npz")) as z, \
            np.load(str(tmp_path / "jax.npz")) as zj:
        assert sorted(z.files) == sorted(zj.files)
        assert "['geometry']['sdf_net']['layers'][0]['w']" in z.files
    back = J.load_params(str(tmp_path / "port.npz"),
                         jax.tree.map(lambda x: x + 1, j["params"]))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(j["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    jstate = {"params": j["params"], "opt_state": {"x": jnp.zeros(3)},
              "step": jnp.asarray(5, jnp.int32)}
    J.save_params(str(tmp_path / "jstate.npz"), jstate)
    got = T.load_params(str(tmp_path / "jstate.npz"),
                        {"params": _perturbed(p["params"])})["params"]
    for k, v in _flat_np(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)

    other = _perturbed(p["params"])
    other["geometry"]["msdf"] = torch.zeros(3)
    got = T.load_params(str(tmp_path / "jax.npz"), other)
    assert torch.equal(got["geometry"]["msdf"], torch.zeros(3))


def test_state_round_trip_is_bit_exact(small, tmp_path):
    """A split state after one step (moments of some leaves, none of
    others) saved and loaded into a fresh state; then one more step from
    each gives equal parameters, moments and counts."""
    from d3human_tpu_torch.train.checkpoint import load_state, save_state
    from d3human_tpu_torch.train.step import init_state, make_train_step
    from d3human_tpu_torch.train.stages import iteration_generator

    j, p = small
    cfg = dataclasses.replace(p["cfg"], optim=dataclasses.replace(
        p["cfg"].optim, warmup_iter=0))
    step = make_train_step("split", p["model"], p["tex"], p["perceptual"],
                           p["perc_params"], cfg, RASTER_OPTS)
    state = init_state("split", _clone(p["params"]), cfg)
    state, _ = step(state, p["target"], iteration_generator(1, 0, "cpu"))
    assert 0 < len(state.opt.mu) < len(state.opt.trainable_paths()) + 1
    save_state(str(tmp_path / "ckp" / "state_0.npz"), state)
    fresh = init_state("split", _clone(p["params"]), cfg)
    loaded = load_state(str(tmp_path / "ckp" / "state_0.npz"), fresh)
    assert loaded.step == state.step == 1 and loaded.opt.count == 1
    assert loaded.opt.mu.keys() == state.opt.mu.keys()
    for k in state.opt.mu:
        assert torch.equal(loaded.opt.mu[k], state.opt.mu[k])
        assert torch.equal(loaded.opt.nu[k], state.opt.nu[k])
    a, _ = step(state, p["target"], iteration_generator(1, 1, "cpu"))
    b, _ = step(loaded, p["target"], iteration_generator(1, 1, "cpu"))
    fa, fb = _flat_np(a.params), _flat_np(b.params)
    for k in fa:
        np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)


def test_cache_paths_and_latest_checkpoint_as_jax(tmp_path):
    from d3human_tpu.config import load_config as jload
    from d3human_tpu.train import checkpoint as J
    from d3human_tpu_torch.config import load_config as tload
    from d3human_tpu_torch.train import checkpoint as T

    box = ((-0.31, -0.72, -0.15), (0.33, 0.81, 0.17))
    for path in CONFIGS:
        for crop in (None, box):
            for kw in ({}, {"cache_dir": str(tmp_path / "c")}):
                assert T.pretrain_cache_paths(tload(path), crop_box=crop,
                                              **kw) == \
                    J.pretrain_cache_paths(jload(path), crop_box=crop, **kw)
    ck = tmp_path / "ckp"
    assert T.latest_checkpoint(str(ck)) is None is J.latest_checkpoint(
        str(ck))
    ck.mkdir()
    assert T.latest_checkpoint(str(ck)) is None
    for n in (2, 10, 9):
        (ck / f"state_{n}.npz").write_bytes(b"")
    (ck / "other_99.npz").write_bytes(b"")
    assert T.latest_checkpoint(str(ck)) == J.latest_checkpoint(str(ck)) \
        == str(ck / "state_10.npz")


def test_tet_grid_cache_crosses_between_packages(tmp_path):
    from d3human_tpu.ops.tet_grid import make_tet_grid as jgrid
    from d3human_tpu_torch.ops.tet_grid import make_tet_grid as tgrid

    box = ((-0.2, -0.5, -0.1), (0.25, 0.4, 0.15))
    kw = dict(res=12, y_offset=-0.1, scale=1.3, crop_box=box)
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    want = jgrid(cache_path=jp, **kw)
    got_from_jax = tgrid(device="cpu", cache_path=jp, **kw)
    got = tgrid(device="cpu", cache_path=tp, **kw)
    back = jgrid(cache_path=tp, **kw)
    for g in (got_from_jax, got, back):
        assert tuple(g.dims) == tuple(want.dims)
        for name in ("verts", "tets", "edges", "tet_edges"):
            np.testing.assert_array_equal(_np(getattr(g, name)),
                                          np.asarray(getattr(want, name)))
    # another input under the same file name rebuilds
    other = tgrid(device="cpu", cache_path=tp, **dict(kw, scale=1.0))
    assert float(other.verts.abs().max()) < float(got.verts.abs().max())


def test_scalar_logger_lines_as_jax(tmp_path):
    from d3human_tpu.utils.logging import ScalarLogger as JL
    from d3human_tpu_torch.utils.logging import ScalarLogger as TL

    for cls, d in ((JL, "j"), (TL, "t")):
        kw = {"use_tensorboard": False} if cls is JL else {}
        lg = cls(str(tmp_path / d), **kw)
        lg.log(3, {"total": 0.25, "n": 7})
        lg.log(4, {"val_psnr": np.float32(21.5)})
        lg.close()
    assert (tmp_path / "t" / "scalars.jsonl").read_text() == \
        (tmp_path / "j" / "scalars.jsonl").read_text()


# ---------------------------------------------------------------- metrics

def test_metrics_match_jax():
    from d3human_tpu.utils import metrics as J
    from d3human_tpu_torch.utils import metrics as T

    rng = np.random.default_rng(3)
    img, ref = rng.uniform(size=(2, 20, 24, 3)).astype(np.float32)
    mask = (rng.uniform(size=(20, 24, 1)) > 0.4).astype(np.float32)
    assert _rel(T.psnr(torch.as_tensor(img), torch.as_tensor(ref)),
                J.psnr(img, ref)) < 1e-5
    assert _rel(T.psnr(torch.as_tensor(img), torch.as_tensor(ref),
                       torch.as_tensor(mask)), J.psnr(img, ref, mask)) < 1e-5
    a, b = img[..., 0], ref[..., 0]
    assert _rel(T.iou(torch.as_tensor(a), torch.as_tensor(b)),
                J.iou(a, b)) < 1e-5
    assert _rel(T.iou(torch.as_tensor(a > 0.5), torch.as_tensor(b > 0.3)),
                J.iou(a > 0.5, b > 0.3)) < 1e-5
    pa = rng.normal(size=(700, 3)).astype(np.float32)
    pb = rng.normal(size=(530, 3)).astype(np.float32) * 1.1
    assert _rel(T.chamfer_distance(torch.as_tensor(pa), torch.as_tensor(pb),
                                   block=128),
                J.chamfer_distance(jnp.asarray(pa), jnp.asarray(pb))) < 1e-5


def test_mesh_chamfer_matches_jax_on_injected_samples():
    """The JAX package's surface samples (its keys) injected into the
    port's ``mesh_chamfer``; the port's own sampler draws from a torch
    generator and lands near."""
    from d3human_tpu.ops.mesh_ops import sample_points_on_mesh
    from d3human_tpu.utils.metrics import mesh_chamfer as jmc
    from d3human_tpu_torch.utils.metrics import mesh_chamfer as tmc

    from d3human_tpu.data.synthetic import make_scene

    sc = make_scene(n_frames=1)
    v = np.asarray(sc.model.v_template)
    f = np.asarray(sc.model.faces)
    v2 = v * 1.02 + 0.01
    n = 4000
    want = jmc(v, f, v2, f, n_samples=n)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    pa = sample_points_on_mesh(k1, jnp.asarray(v), jnp.asarray(f, jnp.int32),
                               n)
    pb = sample_points_on_mesh(k2, jnp.asarray(v2),
                               jnp.asarray(f, jnp.int32), n)
    got = tmc(v, f, v2, f, samples=(torch.as_tensor(np.array(pa)),
                                    torch.as_tensor(np.array(pb))))
    assert abs(got - want) / want < 1e-5
    own = tmc(v, f, v2, f, n_samples=n, device="cpu")
    assert abs(own - want) / want < 0.1


@pytest.mark.parametrize("backbone", ["pyramid", "none"])
def test_weight_free_perceptual_losses_match_jax(backbone):
    from d3human_tpu.models.perceptual import NullPerceptual, PyramidPerceptual
    from d3human_tpu_torch.models.perceptual import make_perceptual

    jm = {"pyramid": PyramidPerceptual, "none": NullPerceptual}[backbone]()
    tm, tp = make_perceptual(backbone, "cpu")
    rng = np.random.default_rng(5)
    x, y = rng.uniform(size=(2, 2, 27, 22, 3)).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda a: jm.loss(jm.init(), a,
                                                  jnp.asarray(y)))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tl = tm.loss(tp, xt, torch.as_tensor(y))
    if backbone == "none":
        assert float(tl) == float(jl) == 0.0
        return
    tl.backward()
    assert _rel(tl.detach(), jl) < 1e-4
    jg = np.asarray(jg)
    assert np.linalg.norm(xt.grad.numpy() - jg) / np.linalg.norm(jg) < 1e-4


def test_mobilenet_backbone_is_refused(capsys):
    """The backbone is ported (``tests/test_torch_mobilenet.py``); what is
    refused is a named weights file that is not there: a warning, and the
    He-init fallback, as in the JAX package."""
    from d3human_tpu_torch.models.mobilenet import MobileNetFeatures
    from d3human_tpu_torch.models.perceptual import make_perceptual

    m, p = make_perceptual("mobilenet", "cpu", "nowhere/weights.npz")
    assert isinstance(m, MobileNetFeatures) and p
    assert "'nowhere/weights.npz' not found" in capsys.readouterr().out


# ---------------------------------------------------------------- validation

NORMAL_TOL = 2e-4     # normal panels: each side extracts its own mesh


def _check_strip(got, want, width, normal_cols, rows=1):
    """Panels of ``width`` pixels: the normal columns within NORMAL_TOL,
    the rest within 1e-5."""
    assert got.shape == want.shape
    H = got.shape[0] // rows
    for c in range(got.shape[1] // width):
        tol = NORMAL_TOL if c in normal_cols else 1e-5
        for r in range(rows):
            np.testing.assert_allclose(
                got[r * H:(r + 1) * H, c * width:(c + 1) * width],
                want[r * H:(r + 1) * H, c * width:(c + 1) * width],
                rtol=0, atol=tol, err_msg=f"row {r} panel {c}")


def _metrics_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1.0), k


def test_validate_stage_matches_jax(small):
    from d3human_tpu.train.validate import validate_stage as jv
    from d3human_tpu_torch.train.validate import validate_stage as tv
    from d3human_tpu.utils.metrics import iou as jiou, psnr as jpsnr
    from d3human_tpu_torch.utils.metrics import iou as tiou, psnr as tpsnr

    j, p = small
    ws, wb = jv(jax.random.PRNGKey(2), j["model"], j["params"], j["tex"],
                j["target"], j["cfg"], raster_opts=JAX_RASTER_OPTS,
                return_buffers=True)
    gs, gb = tv(None, p["model"], p["params"], p["tex"], p["target"],
                p["cfg"], raster_opts=RASTER_OPTS, return_buffers=True)
    W = j["cfg"].render.train_res[1]
    assert int((np.asarray(wb.shaded[..., 3]) > 0.5).sum()) > 50
    _check_strip(gs, np.asarray(ws), W, normal_cols=(4,))
    gt, jgt = p["target"]["all_img"], j["target"]["all_img"]
    _metrics_close(
        {"psnr": float(tpsnr(gb.shaded[..., :3] * gt[..., 3:],
                             gt[..., :3] * gt[..., 3:])),
         "iou": float(tiou(gb.shaded[..., 3] > 0.5, gt[..., 3] > 0.5))},
        {"psnr": float(jpsnr(wb.shaded[..., :3] * jgt[..., 3:],
                             jgt[..., :3] * jgt[..., 3:])),
         "iou": float(jiou(wb.shaded[..., 3] > 0.5, jgt[..., 3] > 0.5))})


def test_validate_split_stage_matches_jax(small):
    from d3human_tpu.train.validate import validate_split_stage as jv
    from d3human_tpu_torch.train.validate import validate_split_stage as tv

    j, p = small
    ws, wm = jv(jax.random.PRNGKey(2), j["model"], j["params"], j["tex"],
                j["target"], j["cfg"], raster_opts=JAX_RASTER_OPTS)
    gs, gm = tv(None, p["model"], p["params"], p["tex"], p["target"],
                p["cfg"], raster_opts=RASTER_OPTS)
    assert wm["cloth_iou"] > 0 and wm["body_iou"] > 0
    _metrics_close(gm, wm)
    _check_strip(gs, np.asarray(ws), j["cfg"].render.train_res[1],
                 normal_cols=(2,), rows=3)


def test_validate_seq_stage_and_visible_triangles_match_jax(small):
    """The seq validation of the scene's body as the template (faces
    labelled by height), and the visible-triangle set of its posed
    mesh."""
    from d3human_tpu.models.geometry import SeqTemplate
    from d3human_tpu.ops.mesh_ops import find_connected_faces
    from d3human_tpu.train.stages import _make_visible_triangles_fn as jvis
    from d3human_tpu.train.validate import validate_seq_stage as jv
    from d3human_tpu_torch.convert import template_from_jax
    from d3human_tpu_torch.train.stages import _make_visible_triangles_fn \
        as tvis
    from d3human_tpu_torch.train.validate import validate_seq_stage as tv

    j, p = small
    sc = j["scene"]
    v = np.asarray(sc.model.v_template)
    f = np.asarray(sc.model.faces)
    lab = sc.garment_faces
    vl = np.zeros(len(v), np.int64)
    vl[np.unique(f[lab == 1])] = 1
    jt = SeqTemplate(
        v=jnp.asarray(v), f=jnp.asarray(f, jnp.int32),
        v_labels=jnp.asarray(vl), face_labels=jnp.asarray(lab, jnp.int32),
        body_vidx=jnp.asarray(np.nonzero(vl == 0)[0], jnp.int32),
        cloth_vidx=jnp.asarray(np.nonzero(vl == 1)[0], jnp.int32),
        body_f=jnp.asarray(f[lab == 0], jnp.int32),
        connected_faces=jnp.asarray(find_connected_faces(f)[0], jnp.int32),
        w_pts=None)
    tt = template_from_jax(to_np(jt), "cpu")
    ws, wm = jv(jax.random.PRNGKey(2), j["model"], j["params"], j["tex"],
                jt, j["target"], j["cfg"], raster_opts=JAX_RASTER_OPTS)
    gs, gm = tv(None, p["model"], p["params"], p["tex"], tt, p["target"],
                p["cfg"], raster_opts=RASTER_OPTS)
    assert wm["cloth_iou"] > 0 and wm["body_iou"] > 0
    _metrics_close(gm, wm)
    _check_strip(gs, np.asarray(ws), j["cfg"].render.train_res[1],
                 normal_cols=(), rows=3)

    jcfg = dataclasses.replace(j["cfg"], render=dataclasses.replace(
        j["cfg"].render, backend="pallas_interpret"))
    posed, _ = j["model"].seq_deformed(j["params"]["geometry"], jt,
                                       j["params"]["pose"], 0)
    want = jvis(jcfg)(posed, jt.f, j["target"]["mvp"])
    got = tvis(p["cfg"])(torch.as_tensor(np.array(posed)), tt.f,
                         p["target"]["mvp"])
    assert len(want) > 20 and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
