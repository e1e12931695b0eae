"""The port's CLI (``python -m d3human_tpu_torch.train_d3h``) on the CPU:
all four stages on ``chip_smoke.py``'s CPU-sized ``cli`` scale (a copy of
``configs/smoke.json`` with the pretrainings cut, the lattice cropped and
48² pixels) through the script's own phase, which also reruns it with
``--resume``; the same on a capture that the port's exporter wrote in the
reference's layout (the phases ``capture_export``, ``capture_data`` and
``capture_cli``); the JAX driver's file tree; a resumed run bit for bit
the uninterrupted one, on the synthetic scene and on the capture; what it
refuses."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """chip_smoke.py's ``cli`` phase at its CPU-sized scale: the first run
    and the resumed one, with the phase's own checks."""
    import chip_smoke

    root = str(tmp_path_factory.mktemp("cli"))
    return chip_smoke.phase_cli("tiny", "cpu", root)


def test_chip_smoke_cli_rehearsal(cli_run):
    """Four stages at their scaled budgets, [done], finite losses and the
    stage outputs (checked inside the phase); the resumed run ran no step
    and kept every PARITY.json entry."""
    st = cli_run["stages"]
    assert {k: st[k]["iterations"] for k in
            ("split_smpl", "init", "split", "seq")} == {
        "split_smpl": 2, "init": 4, "split": 2, "seq": 4}
    assert cli_run["steps"] == 12 and cli_run["resume"]["steps"] == 0
    assert set(cli_run["resume"]["parity_kept"]) >= {
        "split_smpl", "init", "split", "seq_template_frame0", "seq"}
    seq = cli_run["parity"]["seq"]
    assert seq["n_frames"] == 2 and np.isfinite(seq["chamfer_per_frame_max"])
    assert cli_run["cuts"]["stages.sdf_mlp_pretrain_steps"] == [300, 100]
    for name in ("split_smpl", "init", "split"):
        assert st[name]["validation"], name
        assert st[name]["gt_renders"] >= st[name]["iterations"]


def test_chip_smoke_cli_recorded_inputs(cli_run):
    """The first run's kernel inputs, recorded by call site for the
    ``cli_kernels`` phase: every kernel and every stage's resolve is there,
    and each record is held to its plain version as that phase holds the
    kernel (the scatter's recorded rows within rel 1e-5 / abs 1e-6 of the
    plain version and the float32 bound of the float64 sum, the resolve's
    walk of each tile's list alone equal to its walk in chunks of tiles and,
    without a floor, to the benchmark's plain reference, first_k equal to
    ``torch.nonzero`` + pad)."""
    import chip_smoke
    from d3human_tpu_torch.ops import compaction
    from d3human_tpu_torch.ops import raster_resolve as rr

    inputs = cli_run["inputs"]
    assert set(inputs) == {"first_k_indices", "coo_scatter_add",
                           "resolve_tiles"}
    files = {k: {site.split(":")[0] for site in v} for k, v in inputs.items()}
    assert files["first_k_indices"] >= {"marching_tets.py", "rasterizer.py"}
    # the normals' segment add by its caller, the gathers' backward by its
    # own line
    assert files["coo_scatter_add"] >= {"mesh_ops.py", "scatter.py",
                                        "rasterizer.py", "marching_tets.py"}
    stages = {site.split()[1] for site in inputs["resolve_tiles"]}
    assert stages >= {"split_smpl", "init", "split", "seq"}
    for site, s in inputs["first_k_indices"].items():
        mask, k, fill = s["args"]
        assert fill == mask.numel()
        nz = torch.nonzero(mask.reshape(-1)).reshape(-1)[:k].int()
        want = torch.cat([nz, torch.full((k - nz.numel(),), fill,
                                         dtype=torch.int32)])
        assert torch.equal(compaction.first_k_indices(mask, k, fill),
                           want), site
    for site, s in inputs["coo_scatter_add"].items():
        r = chip_smoke.check_scatter_values(site, *s["args"])
        assert r["bitwise"], site
    for site, s in inputs["resolve_tiles"].items():
        rows, faces, starts, big_base, n_big, ntx, floor = s["args"]
        args = (rows, faces, starts, big_base, n_big, (8, 128), ntx)
        got = rr.resolve_tiles(*args, floor)
        # each tile walking its own list alone, not padded to the longest
        # list of its chunk of tiles
        assert torch.equal(got, rr.resolve_tiles_plain(
            *args, floor, tiles_per_chunk=1)), site
        if floor is None:
            assert torch.equal(got, reference_keys(*args)), site


def reference_keys(rows, faces, starts, big_base, n_big, tile, ntx):
    """The same keys from the benchmark's plain reference resolve: each
    tile's list laid out as slots (its own faces, then the shared ones),
    the winners' slots put back as positions in ``faces``."""
    from d3h_bench.reference.ops.raster_resolve import MISS, resolve
    from d3human_tpu_torch.ops.raster_resolve import MISS_KEY

    st = starts.long()
    lens = st[1:] - st[:-1]
    NT, m_own, nb = lens.shape[0], max(int(lens.max()), 1), int(n_big)
    slot = torch.arange(m_own)[None, :]
    own = torch.where(slot < lens[:, None],
                      faces[(st[:-1, None] + slot).clamp(
                          max=faces.shape[0] - 1)], rows.shape[0] - 1)
    glob = faces[big_base:big_base + nb][None].expand(NT, -1)
    slot_faces = torch.cat([own, glob], dim=1)
    ranges = [[(0, m_own)] + ([(m_own, m_own + nb)] if nb else [])
              for _ in range(0, NT, 16)]
    keys = resolve(rows, slot_faces, ranges, tile, ntx)
    s = keys & 0xFFFFFFFF
    pos = torch.where(s < m_own, st[:-1, None] + s, big_base + s - m_own)
    return torch.where(keys == MISS, MISS_KEY, ((keys >> 32) << 32) | pos)


@pytest.fixture(scope="module")
def capture_run(tmp_path_factory):
    """chip_smoke.py's capture phases at their CPU-sized scale: the port's
    exporter at 48², 2 frames, the data checks on its layout, then the CLI
    on it without --synthetic (with the phases' own checks)."""
    import chip_smoke

    root = str(tmp_path_factory.mktemp("capture"))
    export = chip_smoke.phase_capture_export("tiny", "cpu", root)
    data = chip_smoke.phase_capture_data("tiny", "cpu", root)
    run = chip_smoke.phase_cli("tiny", "cpu", os.path.join(root, "cli"),
                               capture=root)
    return dict(run, export=export, data=data, layout=root)


def test_chip_smoke_capture_rehearsal(capture_run):
    """The exporter's 10 PNGs; the dataset within the round-trip bounds,
    frame 0 at twice the resolution giving frame 0's targets, the PNG
    reader exact on every filter, the cache, the SMPL-X-layout
    body model (checked inside the phase); the CLI's four stages at their
    scaled budgets on the capture, with its data timed, no Chamfer in
    PARITY.json and both split halves non-empty."""
    ex, data = capture_run["export"], capture_run["data"]
    assert ex["frames"] == 2 and ex["png_bytes"] > 0
    src2 = data["source_2x"]
    assert src2["resolution"] == [96, 96] and src2["png_bytes"] > 0
    assert src2["targets_equal_frame0"] and src2["resize_equal_cpu"]
    assert set(data["png_filters"]["by_filter"]) == {
        "0", "1", "2", "3", "4", "per row"}
    assert data["body_model"]["joints"] == 55
    assert data["body_model"]["shapedirs"][-1] == 150
    assert data["body_model"]["posedirs"][0] == 486
    st = capture_run["stages"]
    assert {k: st[k]["iterations"] for k in
            ("split_smpl", "init", "split", "seq")} == {
        "split_smpl": 2, "init": 4, "split": 2, "seq": 4}
    assert capture_run["steps"] == 12 and "resume" not in capture_run
    for name in ("split_smpl", "init", "split", "seq"):
        assert st[name]["data_reads"] >= (
            2 if name == "seq" else st[name]["iterations"])
        assert 0 < st[name]["decodes"] <= st[name]["data_reads"]
    assert min(capture_run["split_faces"].values()) > 0
    parity = capture_run["parity"]
    assert set(parity) == {"split_smpl", "init", "split"}
    assert not any(k.startswith("chamfer") for v in parity.values()
                   for k in v)
    assert "--synthetic" not in capture_run["argv"]


def test_capture_cli_writes_the_jax_drivers_file_tree(capture_run):
    out = capture_run["out_dir"]
    missing = [p for p in FILE_TREE if not os.path.exists(os.path.join(
        out, p))]
    assert not missing


def test_chip_smoke_gt_targets_rehearsal():
    import chip_smoke

    out = chip_smoke.phase_gt_targets("tiny", "cpu")
    assert out["covered_pixels"] > 100 and out["tri_id_differs"] == 0
    assert max(out["cache_max_abs_err"].values()) < 4e-4


# the JAX driver's outputs under the out dir, with where each is written
FILE_TREE = [
    "PARITY.json",                                    # train_d3h.py:133
    "smpl_template.obj",                              # train_d3h.py:404-406
    "tet_grid_24_crop0.1.npz",                        # train_d3h.py:198-203
    "split_smpl/split_cloth_imesh_final.obj",         # train_d3h.py:344-346
    "split_smpl/split_body_imesh_final.obj",
    "split_smpl/watertight_imesh_final.obj",          # stages.py:207-213
    "split_smpl/ckp/state_1.npz",                     # stages.py:181-182
    "split_smpl/validate/img_pass1_000001.png",       # stages.py:81-82
    "split_smpl/validate/final_metrics.json",         # stages.py:187-189
    "split_smpl/loss_log/scalars.jsonl",              # stages.py:60
    "close_hole_smpl/body_concat.obj",                # train_d3h.py:347-348
    "close_hole_smpl/cloth_concat.obj",
    "close_hole_smpl/bbox.npz",
    "init/ckp/state_3.npz",                           # train_d3h.py:366-370
    "init/validate/img_pass1_000003.png",             # stages.py:92-93
    "init/validate/final_metrics.json",
    "init/watertight_imesh_final.obj",
    "init/loss_log/scalars.jsonl",
    "split_cloth0/ckp/state_1.npz",                   # train_d3h.py:376-388
    "split_cloth0/validate/final_metrics.json",
    "split_cloth0/split_cloth_imesh_final.obj",
    "split_cloth0/split_body_imesh_final.obj",
    "close_hole_split_cloth0/body_concat.obj",        # train_d3h.py:393-398
    "close_hole_split_cloth0/bbox.npz",
    "processsplit_cloth0/merge_body_cloth.npz",       # train_d3h.py:407-411
    "processsplit_cloth0/inside_body_index.npz",
    "seq/delta/0.npz",                                # stages.py:389-392
    "seq/delta/1.npz",
    "seq/fine_all_0.ply",                             # stages.py:393-394
    "seq/fine_all_1.ply",
    "seq/validate/seq_frame0000.png",                 # stages.py:402-403
    "seq/validate/seq_frame0001.png",
    "seq/ckp/state_frame0.npz",                       # stages.py:409
    "seq/ckp/state_frame1.npz",
    "seq/loss_log/scalars.jsonl",                     # stages.py:343
]


def test_cli_writes_the_jax_drivers_file_tree(cli_run):
    out = cli_run["out_dir"]
    missing = [p for p in FILE_TREE if not os.path.exists(os.path.join(
        out, p))]
    assert not missing
    cache = os.listdir(os.path.join(out, "cache"))
    assert sorted(f.split("_")[0] for f in cache) == ["nonrigid", "sdf"]
    with np.load(os.path.join(out, "seq", "delta", "1.npz")) as z:
        assert z["delta"].ndim == 2 and z["delta"].shape[1] == 3
        assert z["visible_triangles"].dtype == np.int32
        assert len(z["visible_triangles"]) > 0
    with open(os.path.join(out, "split_smpl", "validate",
                           "final_metrics.json")) as fh:
        fm = json.load(fh)
    assert fm["iter"] == 1 and {"psnr", "mask_iou", "body_iou",
                                "cloth_iou"} <= set(fm)
    with open(os.path.join(out, "init", "loss_log", "scalars.jsonl")) as fh:
        first = json.loads(fh.readline())
    assert first["step"] == 0 and "total" in first and "time_ms" in first


def _run(argv, monkeypatch=None, stop_at=None):
    """``main(argv)``; with ``stop_at``, the run is cut off (an exception)
    as it enters its training step number ``stop_at``."""
    import d3human_tpu_torch.train_d3h as cli

    if stop_at is not None:
        orig = cli.make_train_step
        calls = {"n": 0}

        class Cut(Exception):
            pass

        def make(*a, **kw):
            fn = orig(*a, **kw)

            def step(*sa, **skw):
                if calls["n"] == stop_at:
                    raise Cut
                calls["n"] += 1
                return fn(*sa, **skw)
            return step

        monkeypatch.setattr(cli, "make_train_step", make)
        with pytest.raises(Cut):
            cli.main(argv)
        monkeypatch.undo()
        return
    assert cli.main(argv) == 0


def test_resumed_run_equals_uninterrupted_bit_for_bit(cli_run, tmp_path,
                                                      monkeypatch):
    """The init stage, 4 iterations with a state every 2: once straight
    through, once cut off before its fourth step and resumed from
    ``state_2.npz``. The final states are equal bit for bit. Both runs
    start from the rehearsal's pretraining caches."""
    src = cli_run["out_dir"]
    cfg = json.load(open(os.path.join(os.path.dirname(src), "config.json")))
    cfg["stages"]["save_checkpoint_interval"] = 2
    cfg_path = str(tmp_path / "config.json")
    json.dump(cfg, open(cfg_path, "w"))
    finals = []
    for name, cut in (("straight", None), ("cut", 3)):
        out = tmp_path / name
        shutil.copytree(os.path.join(src, "cache"), out / "cache")
        argv = ["--config", cfg_path, "--out-dir", str(out), "--synthetic",
                "--synthetic-frames", "2", "--stages", "init",
                "--iters-scale", "0.002", "--device", "cpu"]
        if cut is not None:
            _run(argv, monkeypatch, stop_at=cut)
            ckp = sorted(os.listdir(out / "init" / "ckp"))
            assert ckp == ["state_2.npz"]
            argv = argv + ["--resume"]
        _run(argv)
        with np.load(out / "init" / "ckp" / "state_3.npz") as z:
            finals.append({k: z[k] for k in z.files})
    a, b = finals
    assert a.keys() == b.keys() and any("['opt']['mu']" in k for k in a)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_run_cut_inside_split_equals_uninterrupted_bit_for_bit(
        cli_run, tmp_path, monkeypatch):
    """The init and split stages (4 + 4 iterations, a state every 2):
    once straight through, once cut off as the split's fourth step starts
    and resumed from the split's ``state_2.npz``. The split's final states
    are equal bit for bit."""
    src = cli_run["out_dir"]
    cfg = json.load(open(os.path.join(os.path.dirname(src), "config.json")))
    cfg["stages"]["save_checkpoint_interval"] = 2
    cfg["stages"]["split_epoch"] = 2000
    cfg_path = str(tmp_path / "config.json")
    json.dump(cfg, open(cfg_path, "w"))
    finals = []
    for name, cut in (("straight", None), ("cut", 7)):
        out = tmp_path / name
        shutil.copytree(os.path.join(src, "cache"), out / "cache")
        argv = ["--config", cfg_path, "--out-dir", str(out), "--synthetic",
                "--synthetic-frames", "2", "--stages", "init,split",
                "--iters-scale", "0.002", "--device", "cpu"]
        if cut is not None:
            _run(argv, monkeypatch, stop_at=cut)
            assert sorted(os.listdir(out / "split_cloth0" / "ckp")) == [
                "state_2.npz"]
            argv = argv + ["--resume"]
        _run(argv)
        with np.load(out / "split_cloth0" / "ckp" / "state_3.npz") as z:
            finals.append({k: z[k] for k in z.files})
    a, b = finals
    assert a.keys() == b.keys() and any("['opt']['mu']" in k for k in a)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_chip_smoke_cli_cut_rehearsal(cli_run, tmp_path):
    """chip_smoke.py's ``cli_cut`` phase: the cli phase's command cut as
    the split's second step starts, then resumed; every final checkpoint
    leaf, seq delta and ply and every PARITY.json number bit for bit the
    straight run's (checked inside the phase)."""
    import chip_smoke

    out = chip_smoke.phase_cli_cut("tiny", "cpu", cli_run,
                                   str(tmp_path / "cut"))
    st = cli_run["stages"]
    assert out["cut_at_step"] == (st["split_smpl"]["iterations"]
                                  + st["init"]["iterations"] + 1)
    assert out["bitwise"] and out["checkpoints"] >= 3
    assert out["deltas"] == out["plys"] == 2


def test_chip_smoke_scorers_rehearsal(cli_run, tmp_path):
    """chip_smoke.py's ``scorers`` phase on the CLI run: eval_parity's
    entries, score_seq_partial equal to the CLI's own seq entry and
    partial on one frame less (checked inside the phase); PARITY.json is
    left as the CLI wrote it."""
    import chip_smoke

    ppath = os.path.join(cli_run["out_dir"], "PARITY.json")
    before = open(ppath).read()
    out = chip_smoke.phase_scorers("tiny", "cpu", cli_run,
                                   str(tmp_path / "scorers"))
    assert open(ppath).read() == before
    assert set(out["multiview"]) == {"split_smpl", "init", "split", "seq"}
    assert out["seq_partial"]["partial"]["n_frames"] == 1
    assert out["seq_partial"]["full"]["n_frames"] == 2


def test_chip_smoke_determinism_rehearsal():
    """chip_smoke.py's ``determinism`` phase on the tiny scene: three init,
    split and seq steps twice in the default mode and once under
    ``deterministic()``, bit for bit; a validation half twice, bit for
    bit."""
    import chip_smoke

    sc = chip_smoke.build_scene("tiny", "cpu", seed_steps=30)
    chip_smoke.add_seq(sc, "tiny")
    out = chip_smoke.phase_determinism(sc, "cpu")
    for stage in ("init", "split", "seq"):
        assert out[stage]["bitwise"] and not out[stage]["nondeterministic_ops"]
        assert len(out[stage]["total"]) == chip_smoke.DET_STEPS
    assert out["validate"]["bitwise"] and out["validate"]["buffers"]


def test_capture_resumed_run_equals_uninterrupted_bit_for_bit(
        capture_run, tmp_path, monkeypatch):
    """As above on the capture: the backgrounds are drawn from (seed,
    stage, iteration), so the resumed run replays them."""
    src = capture_run["out_dir"]
    cfg = json.load(open(os.path.join(os.path.dirname(src), "config.json")))
    cfg["stages"]["save_checkpoint_interval"] = 2
    cfg_path = str(tmp_path / "config.json")
    json.dump(cfg, open(cfg_path, "w"))
    finals = []
    for name, cut in (("straight", None), ("cut", 3)):
        out = tmp_path / name
        shutil.copytree(os.path.join(src, "cache"), out / "cache")
        argv = ["--config", cfg_path, "--out-dir", str(out),
                "--trainset_path", capture_run["layout"], "--folder_name",
                "neutral-synth", "--stages", "init", "--iters-scale",
                "0.002", "--device", "cpu"]
        if cut is not None:
            _run(argv, monkeypatch, stop_at=cut)
            assert sorted(os.listdir(out / "init" / "ckp")) == [
                "state_2.npz"]
            argv = argv + ["--resume"]
        _run(argv)
        with np.load(out / "init" / "ckp" / "state_3.npz") as z:
            finals.append({k: z[k] for k in z.files})
    a, b = finals
    assert a.keys() == b.keys()
    assert any("['pose']['face_offset']" in k for k in a)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_chip_smoke_bake_rehearsal(cli_run, tmp_path):
    """chip_smoke.py's ``bake`` phase on the CLI run (its checks: texels
    covered and finite, the timed rasterization equal to the bake's, the
    bake at the check size equal on the CPU and the device), and the JAX
    package's ``scripts/bake_texture.py`` on the same run: the OBJ text
    equal, the PNGs within one 8-bit level."""
    import sys

    import imageio.v2 as imageio

    import chip_smoke
    import scripts.bake_texture as jscript
    from d3human_tpu_torch.utils.io import load_image

    root = os.path.dirname(cli_run["out_dir"])
    out = chip_smoke.phase_bake("tiny", "cpu", root)
    assert out["lscm"]["charts"] > 1 and out["grid"]["charts"] is None
    for atlas in ("lscm", "grid"):
        dst = tmp_path / atlas
        saved = sys.argv
        sys.argv = ["bake_texture.py", "--run", cli_run["out_dir"],
                    "--stage", "init", "--mesh",
                    os.path.join(cli_run["out_dir"], "init",
                                 "watertight_imesh_final.obj"),
                    "--res", str(chip_smoke.BAKE_SCALES["tiny"]["res"]),
                    "--atlas", atlas, "--out", str(dst), "--config",
                    os.path.join(root, "config.json")]
        try:
            jscript.main()
        finally:
            sys.argv = saved
        mine = os.path.join(root, f"bake_{atlas}")
        with open(dst / "mesh_uv.obj") as a, \
                open(os.path.join(mine, "mesh_uv.obj")) as b:
            assert a.read() == b.read()
        for name in ("texture_kd.png", "texture_ks.png"):
            want = imageio.imread(dst / name).astype(np.int16)
            have = load_image(os.path.join(mine, name)).astype(np.int16)
            assert want.shape == have.shape and want.max() > 0
            assert np.abs(want - have).max() <= 1, (atlas, name)


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """A missing capture layout (the file named), a card that is not
    there; none of them writes the out dir."""
    import d3human_tpu_torch.train_d3h as cli

    out = ["--out-dir", str(tmp_path / "o")]
    with pytest.raises(SystemExit, match="nowhere/f3c/key.list"):
        cli.main(out + ["--trainset_path", str(tmp_path / "nowhere"),
                        "--folder_name", "f3c", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(out + ["--synthetic"])
    assert not os.path.exists(tmp_path / "o")


def test_chip_smoke_cli_parallel_rehearsal(cli_run, tmp_path):
    """chip_smoke.py's cli_parallel phase at its CPU-sized scale: the CLI
    with --stages seq --seq-parallel on a copy of the cli run's out dir
    writes every frame's delta npz with the serial run's keys and offsets'
    shape, its ply with the serial run's counts and the loss_log (checked
    inside the phase); the seq Chamfer lands in PARITY.json."""
    import chip_smoke

    out = chip_smoke.phase_cli_parallel(
        "tiny", "cpu", os.path.dirname(cli_run["out_dir"]),
        str(tmp_path / "par"))
    assert out["frames"] == 2 and out["iters"] == 2
    assert out["parity"]["n_frames"] == 2
    assert np.isfinite(out["parity"]["chamfer_per_frame_max"])


def test_cli_seq_parallel_refusals(tmp_path, monkeypatch):
    """Over more than one process (WORLD_SIZE faked as 2), --seq-parallel
    takes --stages seq only; without the split stage it needs the split
    state of an earlier run. Neither writes the out dir nor starts a
    process group."""
    import torch.distributed as dist

    import d3human_tpu_torch.train_d3h as cli

    out = ["--out-dir", str(tmp_path / "o"), "--synthetic", "--seq-parallel",
           "--device", "cpu"]
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    for stages in ("split_smpl,init,split,seq", "split,seq", "init"):
        with pytest.raises(SystemExit, match="takes --stages seq only"):
            cli.main(out + ["--stages", stages])
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")
    with pytest.raises(SystemExit, match="split_cloth0/ckp"):
        cli.main(out + ["--stages", "seq"])
    assert not os.path.exists(tmp_path / "o")
    assert not dist.is_initialized()
