"""The port's two parity scorers (``d3human_tpu_torch/scripts/
eval_parity.py`` and ``score_seq_partial.py``) against the JAX scripts
(``scripts/eval_parity.py``, ``scripts/score_seq_partial.py``) on the same
checkpoints and meshes: one tiny run of the port's CLI at ``chip_smoke.py``'s
CPU scale, each package scoring its own copy of the out dir (checkpoints
cross between the packages exactly). The Chamfer's surface samples are the
JAX package's, injected into the port's ``mesh_chamfer(samples=...)``;
both sides draw 2,000 a mesh (the tiny CLI scale's count). Tolerances:
ceilings exact, IoUs within one pixel's share of the smallest mask plus
the 4-decimal rounding, PSNR 0.01 dB, Chamfer rel 1e-4 or the 6-decimal
rounding. Then the refusals."""

import functools
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

SAMPLES = 2000
FRAMES = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The CLI's four stages at the tiny scale (no --resume run)."""
    import chip_smoke

    root = str(tmp_path_factory.mktemp("scorers"))
    argv, cfg, _ = chip_smoke.cli_command("tiny", "cpu", root)
    import d3human_tpu_torch.train_d3h as cli

    chip_smoke.run_cli(cli, argv, SAMPLES)
    return dict(argv=argv, cfg=cfg, config=argv[argv.index("--config") + 1],
                out_dir=argv[argv.index("--out-dir") + 1])


def _copy(src, dst):
    """The out dir for one package; the lattice cache is the port's own
    format, so the JAX copy builds its lattice anew."""
    shutil.copytree(src, dst)
    for f in os.listdir(dst):
        if f.startswith("tet_grid_"):
            os.remove(os.path.join(dst, f))
    return str(dst)


def _jax_main(module, argv, monkeypatch):
    """A JAX script's ``main()`` with ``argv``, its Chamfers on SAMPLES
    samples a mesh."""
    import d3human_tpu.utils.metrics as jm

    monkeypatch.setattr(jm, "mesh_chamfer", functools.partial(
        jm.mesh_chamfer, n_samples=SAMPLES))
    monkeypatch.setattr(sys, "argv", ["script.py", *argv])
    module.main()


def _jax_samples(va, fa, vb, fb, *args, **kwargs):
    """The port's ``mesh_chamfer`` on the JAX package's samples: the JAX
    ``mesh_chamfer``'s draws (key 0, split in two)."""
    from d3human_tpu.ops.mesh_ops import sample_points_on_mesh
    from d3human_tpu_torch.utils.metrics import mesh_chamfer

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))

    def draw(k, v, f):
        return torch.as_tensor(np.asarray(sample_points_on_mesh(
            k, jnp.asarray(np.asarray(v, np.float32)),
            jnp.asarray(np.asarray(f), jnp.int32), SAMPLES)))

    return mesh_chamfer(None, None, None, None, samples=(
        draw(k1, va, fa), draw(k2, vb, fb)))


def _close_chamfer(got, want, what):
    assert abs(got - want) <= max(1e-4 * abs(want), 1e-6), (what, got, want)


def _pixel_share(run):
    """One pixel's share of the smallest union a view's IoU divides by
    (at least the ground-truth mask's area)."""
    from d3human_tpu_torch.data.synthetic import make_scene

    scene = make_scene(resolution=tuple(run["cfg"].render.train_res),
                       n_frames=FRAMES, device="cpu")
    areas = []
    for fi in range(FRAMES):
        t = scene.frame_target(fi)
        for k in ("all_img", "cloth_img", "body_img"):
            areas.append(int((t[k][..., 3] > 0.5).sum()))
    return 1.0 / min(areas)


def test_eval_parity_matches_jax(run, tmp_path, monkeypatch):
    monkeypatch.setenv("D3H_PLATFORM", "cpu")
    import scripts.eval_parity as jscript
    from d3human_tpu_torch.scripts import eval_parity

    args = ["--config", run["config"], "--stages",
            "split_smpl,init,split,seq", "--n-views", str(FRAMES),
            "--n-frames", str(FRAMES)]
    jdir = _copy(run["out_dir"], tmp_path / "jax")
    pdir = _copy(run["out_dir"], tmp_path / "port")
    _jax_main(jscript, args + ["--out-dir", jdir], monkeypatch)
    monkeypatch.setattr(eval_parity, "mesh_chamfer", _jax_samples)
    assert eval_parity.main(args + ["--out-dir", pdir, "--device",
                                    "cpu"]) == 0
    want, got = (json.load(open(os.path.join(d, "PARITY_MULTIVIEW.json")))
                 for d in (jdir, pdir))
    assert set(got) == set(want) == {"split_smpl", "init", "split", "seq"}
    share = _pixel_share(run) + 1e-4
    for stage, w in want.items():
        g = got[stage]
        assert set(g) == set(w), stage
        for k, wv in w.items():
            gv = g[k]
            what = f"{stage} {k}"
            if k in ("checkpoint", "n_views", "n_frames") or k.endswith(
                    "_iou_ceiling"):
                assert gv == wv, what
            elif k == "per_frame":
                assert set(gv) == set(wv), what
                for f, row in wv.items():
                    assert set(gv[f]) == set(row), what
                    for c, v in row.items():
                        _close_chamfer(gv[f][c], v, f"{what} {f} {c}")
            elif k.startswith("chamfer"):
                _close_chamfer(gv, wv, what)
            elif k == "psnr_mean":
                assert abs(gv - wv) <= 0.01 + 1e-9, (what, gv, wv)
            elif k.endswith("_iou_of_ceiling"):
                ceil = w[k.replace("_of_ceiling", "_ceiling")]
                assert abs(gv - wv) <= share / ceil + 1e-4, (what, gv, wv)
            else:
                assert k.endswith(("iou_mean", "iou_min")), what
                assert abs(gv - wv) <= share, (what, gv, wv)
    assert want["split"]["cloth_iou_ceiling"] > 0


def test_score_seq_partial_matches_jax(run, tmp_path, monkeypatch):
    """A run cut during seq (frame 0 done, frame 1 cut at its first step):
    the same entry, ``partial`` and ``n_frames`` included, from both
    scripts."""
    monkeypatch.setenv("D3H_PLATFORM", "cpu")
    import scripts.score_seq_partial as jscript
    import d3human_tpu_torch.train_d3h as cli
    from d3human_tpu_torch.scripts import score_seq_partial
    from test_torch_cli import _run

    cut = tmp_path / "cut"
    shutil.copytree(run["out_dir"], cut)
    shutil.rmtree(cut / "seq")
    argv = list(run["argv"])
    argv[argv.index("--out-dir") + 1] = str(cut)
    argv[argv.index("--stages") + 1] = "seq"
    monkeypatch.setattr(cli, "PARITY_SAMPLES", SAMPLES)
    n_first = max(2, int(run["cfg"].stages.seq_iters_first * 0.002))
    with pytest.MonkeyPatch.context() as mp:
        _run(argv, mp, stop_at=n_first)
    assert sorted(f for f in os.listdir(cut / "seq")
                  if f.startswith("fine_all_")) == ["fine_all_0.ply"]
    args = ["--config", run["config"], "--n-frames", str(FRAMES)]
    jdir = _copy(cut, tmp_path / "jax")
    pdir = _copy(cut, tmp_path / "port")
    _jax_main(jscript, args + ["--out-dir", jdir], monkeypatch)
    monkeypatch.setattr(score_seq_partial, "mesh_chamfer", _jax_samples)
    assert score_seq_partial.main(args + ["--out-dir", pdir, "--device",
                                          "cpu"]) == 0
    want, got = (json.load(open(os.path.join(d, "PARITY.json")))["stages"][
        "seq"] for d in (jdir, pdir))
    assert set(got) == set(want)
    assert got["n_frames"] == want["n_frames"] == 1
    assert got["partial"] == want["partial"]
    assert set(got["per_frame"]) == set(want["per_frame"]) == {"0"}
    for k in ("chamfer_per_frame_mean", "chamfer_per_frame_max"):
        _close_chamfer(got[k], want[k], k)
    _close_chamfer(got["per_frame"]["0"], want["per_frame"]["0"], "frame 0")


def test_scorers_refuse(run, tmp_path):
    """``--device cuda`` without a card, and an out dir without seq/."""
    from d3human_tpu_torch.scripts import eval_parity, score_seq_partial

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = ["--config", run["config"], "--n-frames", str(FRAMES),
            "--out-dir", run["out_dir"]]
    for main in (eval_parity.main, score_seq_partial.main):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(args)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert score_seq_partial.main(
        ["--config", run["config"], "--out-dir", str(empty),
         "--device", "cpu"]) == 1
