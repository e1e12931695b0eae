"""CLI: the 4-stage D3-Human reconstruction on the port (counterpart of
``train_d3h.py:49-501``).

    python -m d3human_tpu_torch.train_d3h --config configs/f3c.json \\
        --trainset_path ./data --folder_name neutral-f3c --out-dir out/f3c
    python -m d3human_tpu_torch.train_d3h --config configs/smoke.json \\
        --synthetic --stages init --iters-scale 0.01 --device cpu

Stage graph (ref train.py:1528-1926): split_smpl -> close hole -> init ->
split -> close hole + merge -> seq, on the capture at
``<trainset_path>/<folder_name>`` (the reference's layout,
``data/dataset.py``) with the body model
``<trainset_path>/smplx/SMPLX_<GENDER>.npz`` (the gender is the folder
name's first ``-`` field), or on the built-in synthetic scene
(``--synthetic``); on ``--device`` (default ``cuda``; with no card the run
fails, it never drops to the CPU). ``--resume`` continues every stage from
its newest state and reuses the host steps' finished outputs.

A capture's frames are composited over a random background, as the JAX
driver does; the background of an iteration is drawn from a generator
seeded by (seed, stage, iteration), so a resumed run replays it (the JAX
driver draws from one running stream). ``--seq-parallel`` runs the seq
stage frame-parallel (``train/stages.py:run_seq_stage_parallel``): with one
process after the stages before it, or under ``torchrun --nproc_per_node
N`` with ``--stages seq`` only, each rank a device and its block of the
frames; without ``split`` in the stage list, the parameters are the split
stage's newest state on disk. The JAX driver's ``precompile_async`` has no
counterpart: PyTorch compiles nothing ahead of a step. The pretraining
caches and the lattice cache live under the out dir (``cache/``,
``tet_grid_*.npz``), so a fresh out dir starts from nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from d3human_tpu_torch.config import load_config
from d3human_tpu_torch.data.dataset import (
    FrameDataset, composite_background, shuffled_indexer,
)
from d3human_tpu_torch.data.synthetic import CachedTargets, make_scene
from d3human_tpu_torch.models.geometry import GeometryModel
from d3human_tpu_torch.models.perceptual import make_perceptual
from d3human_tpu_torch.models.smplx.deformer import SMPLXDeformer
from d3human_tpu_torch.models.smplx.model import load_smplx_npz
from d3human_tpu_torch.models.texture import MLPTexture3D
from d3human_tpu_torch.ops.tet_grid import make_tet_grid
from d3human_tpu_torch.parallel.mesh import maybe_distributed_init, rank_device
from d3human_tpu_torch.pipeline.components import process_close_hole
from d3human_tpu_torch.pipeline.template import (
    build_seq_template, merge_body_cloth,
)
from d3human_tpu_torch.render.light import create_trainable_env
from d3human_tpu_torch.train.checkpoint import (
    cached_sdf_pretrain, latest_checkpoint, load_params, load_state,
    pretrain_cache_paths, save_params,
)
from d3human_tpu_torch.train.stages import (
    export_stage_meshes, fold_in, iteration_generator, run_seq_stage,
    run_seq_stage_parallel, run_stage,
)
from d3human_tpu_torch.train.step import init_state, make_train_step
from d3human_tpu_torch.utils import io as mesh_io
from d3human_tpu_torch.utils.metrics import mesh_chamfer

# surface samples per mesh of each PARITY.json Chamfer (the JAX driver's,
# mesh_chamfer's default)
PARITY_SAMPLES = 30000


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("d3human_tpu_torch")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--out-dir", dest="out_dir", type=str, default="out/run")
    p.add_argument("--trainset_path", type=str, default="./data",
                   help="root of the captures and of smplx/SMPLX_*.npz")
    p.add_argument("--folder_name", type=str, default="",
                   help="the capture under --trainset_path; its first "
                        "'-' field is the body model's gender")
    p.add_argument("--synthetic", action="store_true",
                   help="run on the built-in synthetic scene")
    p.add_argument("--synthetic-frames", type=int, default=64,
                   help="synthetic capture length (turntable frame count)")
    p.add_argument("--stages", type=str, default="split_smpl,init,split,seq",
                   help="comma-separated subset of the stage graph")
    p.add_argument("--iters-scale", type=float, default=1.0,
                   help="scale all stage iteration counts: "
                        "max(2, int(n * scale))")
    p.add_argument("--seq-parallel", action="store_true",
                   help="optimize every seq frame independently from the "
                        "shared post-split state (no warm start; each "
                        "frame the first frame's iteration budget), the "
                        "frames split over the processes of torchrun "
                        "(--stages seq only with more than one)")
    p.add_argument("--resume", action="store_true",
                   help="resume each stage from its newest state (params, "
                        "optimizer moments, step) and reuse finished host "
                        "outputs")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def _synth_gt_mesh(scene, frame: int):
    """(verts, faces) of the synthetic capture's posed body at ``frame``
    (the scene's own pose tensors, which training never updates)."""
    pp = scene.pose_params
    sl = slice(frame, frame + 1)
    with torch.no_grad():
        v, _, _ = scene.model.forward(
            betas=pp["shape"], root_pose=pp["root_pose"][sl],
            body_pose=pp["body_pose"][sl], transl=pp["trans"][sl])
    return v[0], np.asarray(scene.model.faces)


# the tag of the background draws among the run's generators
BACKGROUND_TAG = 5


def load_capture(args, train_res, dev):
    """(dataset, body model) of the capture ``--trainset_path`` /
    ``--folder_name``: the JAX driver's capture branch
    (``train_d3h.py:163-186``). A missing file of the layout ends the run
    with a message naming it."""
    root = os.path.join(args.trainset_path, args.folder_name)
    gender = args.folder_name.split("/")[-1].split("-")[0] or "neutral"
    try:
        dataset = FrameDataset(root, train_res, device=dev)
        model_sx = load_smplx_npz(os.path.join(args.trainset_path, "smplx"),
                                  gender=gender, device=dev)
    except FileNotFoundError as e:
        raise SystemExit(f"d3human_tpu_torch.train_d3h: no capture at "
                         f"{root!r}: {e} (pass --synthetic for the built-in "
                         "scene)") from e
    return dataset, model_sx


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    stages = args.stages.split(",")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.seq_parallel and world > 1 and stages != ["seq"]:
        # every rank would run the stages before seq in full, and wait at
        # the seq stage's barrier for the slowest
        raise SystemExit(
            f"d3human_tpu_torch.train_d3h: --seq-parallel over {world} "
            f"processes takes --stages seq only (got {args.stages!r}): run "
            "the stages before it in one process first, into the same "
            "--out-dir")
    dev = rank_device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(
                "d3human_tpu_torch.train_d3h: --device cuda but no CUDA "
                "device is available (pass --device cpu for a CPU run)")
        # float32 throughout, as the JAX package computes at "highest"
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(dev)
    cfg = load_config(args.config, overrides={"out_dir": args.out_dir})
    split_ckp = None
    if args.seq_parallel and "split" not in stages:
        split_ckp = latest_checkpoint(os.path.join(cfg.out_dir,
                                                   "split_cloth0", "ckp"))
        if split_ckp is None:
            raise SystemExit(
                "d3human_tpu_torch.train_d3h: --seq-parallel without the "
                "split stage needs its state in "
                f"{os.path.join(cfg.out_dir, 'split_cloth0', 'ckp')} from "
                "an earlier run")
    own_group = args.seq_parallel and maybe_distributed_init(dev)
    lead = not dist.is_initialized() or dist.get_rank() == 0

    # ---- data and body model
    scene = None
    if args.synthetic:
        scene = make_scene(resolution=tuple(cfg.render.train_res),
                           n_frames=args.synthetic_frames, device=dev)
        deformer, canon = scene.deformer, scene.canon
        # training updates the pose in place: the scene keeps its own
        pose0 = {k: v.clone() for k, v in scene.pose_params.items()}
        n_images = scene.n_frames
        src = scene
        if cfg.stages.synthetic_target_cache:
            src = CachedTargets(scene)
            print(f"[data] on-device fp16 target cache: {scene.n_frames} "
                  f"frames at {cfg.render.train_res}", flush=True)

        def get_frame(frame, stage, it):
            return src.frame_target(frame)
    else:
        dataset, model_sx = load_capture(args, cfg.render.train_res, dev)
        deformer = SMPLXDeformer(model_sx)
        shape = torch.as_tensor(dataset.smplx_params["shape"], device=dev)
        canon = deformer.initialize(shape[:, :model_sx.num_betas])
        # the per-frame poses, the shape and the three offsets
        pose0 = {k: torch.as_tensor(v, device=dev)
                 for k, v in dataset.smplx_params.items()}
        n_images = dataset.n_images
        bg_seed = fold_in(cfg.seed, BACKGROUND_TAG)

        def get_frame(frame, stage, it):
            """Frame ``frame`` over a random background drawn from
            (seed, stage, iteration)."""
            return composite_background(
                dataset.frame_target(frame), "random",
                iteration_generator(fold_in(bg_seed, stage), it, dev))
    order = shuffled_indexer(n_images, seed=cfg.seed)

    def targets(stage):
        """it -> the target of iteration ``it`` of stage number ``stage``
        (0 split_smpl, 1 init, 2 split): frames in the shuffled order."""
        return lambda it: get_frame(order(it), stage, it)

    os.makedirs(cfg.out_dir, exist_ok=True)

    def s(n):
        return max(2, int(n * args.iters_scale))

    # ---- parity bookkeeping: the validation metrics and, on the synthetic
    # scene, per-stage Chamfer to its posed body, in PARITY.json
    parity: dict = {"config": args.config, "iters_scale": args.iters_scale,
                    "stages": {}}
    ppath = os.path.join(cfg.out_dir, "PARITY.json")
    if args.resume and os.path.exists(ppath):
        try:
            with open(ppath) as fh:
                parity["stages"].update(json.load(fh).get("stages", {}))
        except (OSError, ValueError):
            pass

    def write_parity():
        with open(ppath, "w") as fh:
            json.dump(parity, fh, indent=1)

    def record_parity(stage_name, stage_dir, mesh_paths=None, frame=0):
        entry = {}
        fm = os.path.join(stage_dir, "validate", "final_metrics.json")
        if os.path.exists(fm):
            with open(fm) as fh:
                entry.update(json.load(fh))
        if scene is not None and mesh_paths:
            gt_v, gt_f = _synth_gt_mesh(scene, frame)
            for name, path in mesh_paths.items():
                v, f = mesh_io.load_obj(path)
                if len(f) == 0:
                    continue
                entry[f"chamfer_{name}"] = round(mesh_chamfer(
                    v, f, gt_v, gt_f, PARITY_SAMPLES, device=dev), 6)
        parity["stages"][stage_name] = entry
        write_parity()
        print(f"[parity] {stage_name}: {entry}", flush=True)

    # ---- model
    g = cfg.geometry
    crop_box, crop_tag = None, ""
    if g.grid_crop > 0:
        cb = canon.vs_template[0].cpu().numpy()
        crop_box = (tuple(cb.min(0) - g.grid_crop),
                    tuple(cb.max(0) + g.grid_crop))
        crop_tag = f"_crop{g.grid_crop:g}"
    grid = make_tet_grid(
        res=g.grid_res, bounds=((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5)),
        y_offset=g.grid_y_offset, scale=g.grid_scale, crop_box=crop_box,
        device=dev, cache_path=os.path.join(
            cfg.out_dir, f"tet_grid_{g.grid_res}{crop_tag}.npz"))
    if crop_box is not None:
        print(f"[grid] crop {grid.dims} of {g.grid_res}^3 "
              f"({grid.n_verts} verts, {grid.n_tets} tets)", flush=True)
    model = GeometryModel(cfg, grid, deformer, canon)

    def generator(tag):
        return torch.Generator().manual_seed(fold_in(cfg.seed, tag))

    run_seed = fold_in(cfg.seed, 3)
    gparams = model.init_params(generator(0), n_images=n_images)

    pcache, ncache = pretrain_cache_paths(
        cfg, cache_dir=os.path.join(cfg.out_dir, "cache"), crop_box=crop_box)
    if split_ckp is not None:
        print(f"[pretrain] skipped: the parameters come from {split_ckp}",
              flush=True)
    else:
        print("[pretrain] SDF -> template body SDF", flush=True)
        gparams, ploss = cached_sdf_pretrain(
            model, gparams, cfg.stages.sdf_mlp_pretrain_steps, pcache)
        print(f"[pretrain] done, loss="
              f"{'cached' if ploss is None else f'{ploss:.2e}'}", flush=True)
        if os.path.exists(ncache):
            print(f"[pretrain] cached nonrigid <- {ncache}", flush=True)
            gparams = dict(gparams)
            gparams["nonrigid"] = load_params(ncache, gparams["nonrigid"])
        else:
            gparams = model.pretrain_nonrigid_zero(
                gparams, cfg.stages.sdf_deform_pretrain_steps)
            save_params(ncache, gparams["nonrigid"])

    r = cfg.render
    tex = MLPTexture3D(cfg.texture, (list(r.kd_min[:3]) + list(r.ks_min),
                                     list(r.kd_max[:3]) + list(r.ks_max)),
                       dev)
    perceptual, perc_params = make_perceptual(cfg.loss.perceptual_backbone,
                                              dev, cfg.loss.perceptual_npz)
    params = {
        "geometry": gparams,
        "pose": pose0,
        "material": tex.init(generator(1)),
        "light": create_trainable_env(generator(2), r.probe_res,
                                      device=dev),
    }
    if split_ckp is not None:
        params = load_state(split_ckp, init_state("split", params,
                                                  cfg)).params

    def stage_state(stage):
        return (init_state(stage, params, cfg),
                make_train_step(stage, model, tex, perceptual, perc_params,
                                cfg))

    def maybe_resume(state, stage_dir, n_iters):
        """--resume: the stage's newest state and the iteration after it
        (a finished stage resumes at n_iters, so its loop runs nothing)."""
        if not args.resume:
            return state, 0
        ck = latest_checkpoint(os.path.join(stage_dir, "ckp"))
        if ck is None:
            return state, 0
        state = load_state(ck, state)
        start_it = int(os.path.basename(ck)[len("state_"):-4])
        print(f"[resume] {ck} -> start_it={start_it + 1}", flush=True)
        return state, min(start_it + 1, n_iters)

    # ---- stage graph. A finished stage's state (and its Adam moments)
    # is dropped before the next stage builds its own.
    state = None
    if "split_smpl" in stages:
        state, step_fn = stage_state("split")
        sdir = os.path.join(cfg.out_dir, "split_smpl")
        n = s(cfg.stages.split_smpl_epoch)
        state, start_it = maybe_resume(state, sdir, n)
        state = run_stage("split_smpl", n, state, step_fn, targets(0), cfg,
                          sdir, fold_in(run_seed, 0), model,
                          start_it=start_it, tex_module=tex)
        params, state = state.params, None
        paths = export_stage_meshes(model, params, sdir, "final")
        process_close_hole(os.path.join(cfg.out_dir, "close_hole_smpl"),
                           paths["body"], paths["cloth"])
        record_parity("split_smpl", sdir, paths)

    if "init" in stages:
        params = dict(params)
        params["geometry"] = model.reinit_fields(generator(7),
                                                 params["geometry"])
        params["geometry"], _ = cached_sdf_pretrain(
            model, params["geometry"], cfg.stages.sdf_mlp_pretrain_steps,
            pcache)
        state, step_fn = stage_state("init")
        sdir = os.path.join(cfg.out_dir, "init")
        n = s(cfg.stages.init_epoch)
        state, start_it = maybe_resume(state, sdir, n)
        state = run_stage("init", n, state, step_fn, targets(1), cfg, sdir,
                          fold_in(run_seed, 1), model, start_it=start_it,
                          tex_module=tex)
        params, state = state.params, None
        paths = export_stage_meshes(model, params, sdir, "final")
        record_parity("init", sdir, {"watertight": paths["watertight"]})

    process_dir = os.path.join(cfg.out_dir, "processsplit_cloth0")
    if "split" in stages:
        state, step_fn = stage_state("split")
        sdir = os.path.join(cfg.out_dir, "split_cloth0")
        n = s(cfg.stages.split_epoch)
        state, start_it = maybe_resume(state, sdir, n)
        state = run_stage("split", n, state, step_fn, targets(2), cfg, sdir,
                          fold_in(run_seed, 2), model, start_it=start_it,
                          tex_module=tex)
        params, state = state.params, None
        paths = export_stage_meshes(model, params, sdir, "final")
        record_parity("split", sdir, paths)
        # the host surgery; on --resume each step whose last-written file
        # exists is reused (train_d3h.py:389-416)
        ch_dir = os.path.join(cfg.out_dir, "close_hole_split_cloth0")
        ch = {"body": os.path.join(ch_dir, "body_concat.obj"),
              "cloth": os.path.join(ch_dir, "cloth_concat.obj"),
              "bbox": os.path.join(ch_dir, "bbox.npz")}
        if not (args.resume and os.path.exists(ch["bbox"])):
            ch = process_close_hole(ch_dir, paths["body"], paths["cloth"])
        else:
            print("[close_hole] resume: reusing", ch_dir, flush=True)
        # the SMPL template: the under-cloth body patch donor of the cut
        smpl_path = os.path.join(cfg.out_dir, "smpl_template.obj")
        mesh_io.write_obj(smpl_path, canon.vs_template[0],
                          np.asarray(deformer.model.faces))
        merge_marker = os.path.join(process_dir, "inside_body_index.npz")
        if not (args.resume and os.path.exists(merge_marker)):
            merge_body_cloth(process_dir, ch["body"], ch["cloth"],
                             grid_res=min(96, g.grid_res),
                             smpl_obj=smpl_path, bbox_npz=ch.get("bbox"),
                             device=dev)
        else:
            print("[merge] resume: reusing", process_dir, flush=True)

    if "seq" in stages:
        template = build_seq_template(process_dir, device=dev)
        if scene is not None and lead:
            # the merge's error floor: the unoptimised template posed to
            # frame 0 against the ground-truth surface
            t0 = get_frame(0, 3, 0)
            with torch.no_grad():
                posed0 = model.pose_verts(template.v, params["pose"],
                                          int(t0["frame_idx"]))
            gt_v0, gt_f0 = _synth_gt_mesh(scene, 0)
            ch_t = mesh_chamfer(posed0, template.f, gt_v0, gt_f0,
                                PARITY_SAMPLES, device=dev)
            parity["stages"]["seq_template_frame0"] = {
                "chamfer_unoptimized_template": round(ch_t, 6),
                "n_faces": int(template.f.shape[0]),
                "n_verts": int(template.v.shape[0])}
            write_parity()
            print(f"[parity] seq template frame0 chamfer={ch_t:.6f} "
                  f"({template.f.shape[0]} faces)", flush=True)
        if cfg.stages.seq_static_skin_weights:
            with torch.no_grad():
                template = dataclasses.replace(
                    template, w_pts=model.static_skin_weights(template.v))
        cfg_seq = cfg
        if args.iters_scale != 1.0:
            cfg_seq = dataclasses.replace(cfg, stages=dataclasses.replace(
                cfg.stages, seq_iters_first=s(cfg.stages.seq_iters_first),
                seq_iters_rest=s(cfg.stages.seq_iters_rest)))
        seq_dir = os.path.join(cfg.out_dir, "seq")
        if args.seq_parallel:
            run_seq_stage_parallel(
                params, template, lambda f: get_frame(f, 3, f),
                n_frames=n_images, cfg=cfg_seq, save_path=seq_dir,
                seed=fold_in(run_seed, 3), model=model, tex_module=tex,
                perceptual=perceptual, perc_params=perc_params)
        else:
            step_fn = make_train_step("seq", model, tex, perceptual,
                                      perc_params, cfg, template=template)
            state = run_seq_stage(init_state("seq", params, cfg), step_fn,
                                  template, lambda f: get_frame(f, 3, f),
                                  n_frames=n_images,
                                  cfg=cfg_seq, save_path=seq_dir,
                                  seed=fold_in(run_seed, 3), model=model,
                                  tex_module=tex)
            params, state = state.params, None
        # per-frame Chamfer of the fitted seq meshes to the posed ground
        # truth (fine_all_*.ply)
        chs = []
        for fn in (sorted(os.listdir(seq_dir)) if scene is not None and lead
                   else ()):
            m = re.match(r"fine_all_(\d+)\.ply", fn)
            if not m:
                continue
            v, f = mesh_io.read_ply(os.path.join(seq_dir, fn))
            gt_v, gt_f = _synth_gt_mesh(scene, int(m.group(1)))
            chs.append(mesh_chamfer(v, f, gt_v, gt_f, PARITY_SAMPLES,
                                    device=dev))
        if chs:
            record_parity("seq", seq_dir, None)
            parity["stages"]["seq"].update({
                "chamfer_per_frame_mean": round(float(np.mean(chs)), 6),
                "chamfer_per_frame_max": round(float(np.max(chs)), 6),
                "n_frames": len(chs)})
            write_parity()

    print("[done]", flush=True)
    if own_group:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
