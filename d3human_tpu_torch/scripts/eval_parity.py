"""Multi-view parity re-scoring from saved stage checkpoints (counterpart
of ``scripts/eval_parity.py``).

PARITY.json's per-stage psnr / mask_iou come from one fixed validation
view, and the silhouette IoU moves by about ±0.08 across the turntable, so
this script loads each stage's newest state checkpoint and scores the mean
and min IoU and the mean PSNR over N evenly spaced views; for the split
stages also each half's IoU against its analytic ceiling and the exported
halves' Chamfer to the ground-truth parts; for the seq stage the
per-frame, per-part Chamfer of its meshes. It writes
``PARITY_MULTIVIEW.json`` next to PARITY.json, with the JAX script's keys.

    python -m d3human_tpu_torch.scripts.eval_parity --out-dir <run> \\
        --config <the run's config> --stages split_smpl,init,split,seq \\
        --n-views 8 --n-frames <the run's --synthetic-frames> \\
        [--device cuda|cpu]

Synthetic scenes only (a capture has no exact ground-truth masks).
``--n-frames`` must be the run's frame count: the scene's poses depend on
it. ``--device`` is ``cuda`` unless asked otherwise; without a card the
run stops with a message (it never drops to the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import List, Optional

import numpy as np
import torch

from d3human_tpu_torch.config import load_config
from d3human_tpu_torch.data.synthetic import make_scene
from d3human_tpu_torch.models.geometry import GeometryModel
from d3human_tpu_torch.ops.rasterizer import rasterize_bruteforce, xfm_points
from d3human_tpu_torch.pipeline.template import build_seq_template
from d3human_tpu_torch.render.light import create_trainable_env
from d3human_tpu_torch.train.checkpoint import latest_checkpoint, load_state
from d3human_tpu_torch.train.stages import fold_in
from d3human_tpu_torch.train.step import init_state
from d3human_tpu_torch.train.validate import (
    validate_split_stage, validate_stage,
)
from d3human_tpu_torch.train_d3h import (
    _synth_gt_mesh, build_lattice, texture_module,
)
from d3human_tpu_torch.utils import io as mesh_io
from d3human_tpu_torch.utils.backend import device_or_exit
from d3human_tpu_torch.utils.metrics import mesh_chamfer, psnr

NAME = "d3human_tpu_torch.scripts.eval_parity"


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(prog=NAME)
    p.add_argument("--config", default="configs/f3c_synth.json")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--stages", default="split_smpl,init,split,seq")
    p.add_argument("--n-views", type=int, default=8)
    p.add_argument("--n-frames", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def make_part_ceilings(scene):
    """Per-view IoU ceilings of the split halves from the ground-truth
    geometry alone: the oracle rasterizer's coverage of the GT mesh's
    garment faces (body faces) against the GT visible-garment (visible-
    body) mask, the best any reconstruction's half can reach (the body
    half renders the cloth-occluded torso; the cloth half is an open
    shell whose back faces project too)."""
    dev = scene.mvp.device
    faces = torch.as_tensor(np.asarray(scene.model.faces, np.int32),
                            device=dev)
    garment = torch.as_tensor(np.asarray(scene.garment_faces) > 0.5,
                              device=dev)

    def coverage(frame_idx):
        verts, _ = _synth_gt_mesh(scene, frame_idx)
        v_clip = xfm_points(verts, scene.mvp)

        def cov(face_valid):
            with torch.no_grad():
                r = rasterize_bruteforce(v_clip, faces, face_valid,
                                         scene.resolution)
            return (r.tri_id > 0).cpu().numpy()

        return cov(garment), cov(~garment)

    def ceilings(frame_idx, target):
        cloth_cov, body_cov = coverage(frame_idx)
        gt_cloth = target["cloth_img"][..., 3].cpu().numpy() > 0.5
        gt_body = target["body_img"][..., 3].cpu().numpy() > 0.5

        def i(a, b):
            return float((a & b).sum() / max((a | b).sum(), 1))
        return {"cloth": i(cloth_cov, gt_cloth), "body": i(body_cov, gt_body)}

    return ceilings


def part_chamfers(scene, frame, mesh_paths, dev):
    """Per-part Chamfer of the exported split meshes against the GT part
    surfaces (the garment-labelled face subsets of the GT posed mesh)."""
    gt_v, gt_f = _synth_gt_mesh(scene, frame)
    garment = np.asarray(scene.garment_faces) > 0.5
    out = {}
    for part, gf in (("cloth", gt_f[garment]), ("body", gt_f[~garment])):
        path = mesh_paths.get(part)
        if path is None or not os.path.exists(path) or len(gf) == 0:
            continue
        mv, mf = mesh_io.load_obj(path)
        if len(mf) == 0:
            continue
        out[f"chamfer_{part}_vs_gtpart"] = round(
            mesh_chamfer(mv, mf, gt_v, gf, device=dev), 6)
    return out


def score_seq_stage(cfg, scene, dev):
    """Per-frame, per-part Chamfer of the saved seq meshes
    (``fine_all_<f>.ply``, the merged template's faces) against the GT
    posed part surfaces, or None without a seq dir or a merge template."""
    seq_dir = os.path.join(cfg.out_dir, "seq")
    process_dir = os.path.join(cfg.out_dir, "processsplit_cloth0")
    if not os.path.isdir(seq_dir):
        print("[seq] no seq dir, skipping", flush=True)
        return None
    try:
        template = build_seq_template(process_dir, device="cpu")
    except (FileNotFoundError, OSError):
        print("[seq] no merge template, skipping", flush=True)
        return None
    t_f = template.f.cpu().numpy()
    t_labels = template.face_labels.cpu().numpy()
    garment = np.asarray(scene.garment_faces) > 0.5

    per_frame = {}
    for fn in sorted(os.listdir(seq_dir)):
        m = re.match(r"fine_all_(\d+)\.ply", fn)
        if not m:
            continue
        frame = int(m.group(1))
        v, f = mesh_io.read_ply(os.path.join(seq_dir, fn))
        if f.shape[0] != t_f.shape[0]:
            print(f"[seq] {fn}: face count {f.shape[0]} != template "
                  f"{t_f.shape[0]}; whole-mesh chamfer only", flush=True)
            labels = None
        else:
            labels = t_labels
        gt_v, gt_f_all = _synth_gt_mesh(scene, frame)
        row = {"chamfer_all": round(mesh_chamfer(v, f, gt_v, gt_f_all,
                                                 device=dev), 6)}
        if labels is not None:
            for part, sel, gsel in (("cloth", labels == 1, garment),
                                    ("body", labels == 0, ~garment)):
                if sel.sum() and gsel.sum():
                    row[f"chamfer_{part}"] = round(mesh_chamfer(
                        v, f[sel], gt_v, gt_f_all[gsel], device=dev), 6)
        per_frame[frame] = row
        print(f"[seq] frame {frame}: {row}", flush=True)
    if not per_frame:
        return None
    entry = {"n_frames": len(per_frame), "per_frame": per_frame}
    for k in ("chamfer_all", "chamfer_cloth", "chamfer_body"):
        vals = [r[k] for r in per_frame.values() if k in r]
        if vals:
            entry[f"{k}_mean"] = round(float(np.mean(vals)), 6)
            entry[f"{k}_max"] = round(float(np.max(vals)), 6)
    return entry


def build_model(cfg, scene, dev):
    """(model, texture, a fresh parameter tree) as the CLI builds them, on
    the run's (crop-aware) lattice."""
    grid, _ = build_lattice(cfg, scene.canon, dev)
    model = GeometryModel(cfg, grid, scene.deformer, scene.canon)
    tex = texture_module(cfg, dev)

    def generator(tag):
        return torch.Generator().manual_seed(fold_in(cfg.seed, tag))

    params = {
        "geometry": model.init_params(generator(0),
                                      n_images=scene.n_frames),
        "pose": {k: v.clone() for k, v in scene.pose_params.items()},
        "material": tex.init(generator(1)),
        "light": create_trainable_env(generator(2), cfg.render.probe_res,
                                      device=dev),
    }
    return model, tex, params


def score_stage(stage, cfg, scene, model, tex, params, ceilings_fn, n_views,
                dev):
    """The stage's entry of PARITY_MULTIVIEW.json, or None without a
    checkpoint."""
    # the split stage's artifacts land in split_cloth0 (as the CLI writes)
    sdir = os.path.join(cfg.out_dir,
                        "split_cloth0" if stage == "split" else stage)
    ck = latest_checkpoint(os.path.join(sdir, "ckp"))
    if ck is None:
        print(f"[{stage}] no checkpoint, skipping", flush=True)
        return None
    kind = "split" if stage.startswith("split") else stage
    state = load_state(ck, init_state(kind, params, cfg))
    split_mode = stage.startswith("split")

    ious, psnrs = [], []
    part_ious = {"body": [], "cloth": []}
    part_ceils = {"body": [], "cloth": []}
    step = max(1, scene.n_frames // n_views)
    for fi in range(0, scene.n_frames, step):
        t = scene.frame_target(fi)
        gen = torch.Generator(device=dev).manual_seed(
            fold_in(cfg.seed, 1000 + fi))
        if split_mode:
            _, m = validate_split_stage(gen, model, state.params, tex, t,
                                        cfg)
            ious.append(float(m["mask_iou"]))
            psnrs.append(float(m["psnr"]))
            ceil = ceilings_fn(fi, t)
            for part in ("body", "cloth"):
                if f"{part}_iou" in m:
                    part_ious[part].append(float(m[f"{part}_iou"]))
                    part_ceils[part].append(ceil[part])
        else:
            _, buf = validate_stage(gen, model, state.params, tex, t, cfg,
                                    return_buffers=True)
            gt = t["all_img"]
            pa = (buf.shaded[..., 3] > 0.5).cpu().numpy()
            ga = (gt[..., 3] > 0.5).cpu().numpy()
            ious.append(float((pa & ga).sum() / max((pa | ga).sum(), 1)))
            psnrs.append(float(psnr(buf.shaded[..., :3] * gt[..., 3:],
                                    gt[..., :3] * gt[..., 3:])))
        print(f"[{stage}] frame {fi}: iou={ious[-1]:.4f} "
              f"psnr={psnrs[-1]:.2f}", flush=True)
    entry = {
        "checkpoint": os.path.basename(ck),
        "n_views": len(ious),
        "iou_mean": round(float(np.mean(ious)), 4),
        "iou_min": round(float(np.min(ious)), 4),
        "psnr_mean": round(float(np.mean(psnrs)), 2),
    }
    # per-part silhouette IoUs of the split stages, each against its
    # ceiling ("X of a possible Y"): the body half renders the occluded
    # torso, so its IoU has a floor by construction
    for part, vals in part_ious.items():
        if vals:
            entry[f"{part}_iou_mean"] = round(float(np.mean(vals)), 4)
            ceil = float(np.mean(part_ceils[part]))
            entry[f"{part}_iou_ceiling"] = round(ceil, 4)
            entry[f"{part}_iou_of_ceiling"] = round(
                float(np.mean(vals)) / max(ceil, 1e-6), 4)
    if split_mode:
        mesh_paths = {part: os.path.join(sdir, f"split_{part}_imesh_final.obj")
                      for part in ("body", "cloth")}
        entry.update(part_chamfers(scene, 0, mesh_paths, dev))
    return entry


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    dev = device_or_exit(NAME, args.device)
    cfg = load_config(args.config, overrides={"out_dir": args.out_dir})
    scene = make_scene(resolution=tuple(cfg.render.train_res),
                       n_frames=args.n_frames, device=dev)
    model, tex, params = build_model(cfg, scene, dev)
    ceilings_fn = make_part_ceilings(scene)
    out = {}
    opath = os.path.join(cfg.out_dir, "PARITY_MULTIVIEW.json")
    if os.path.exists(opath):
        with open(opath) as fh:
            out = json.load(fh)

    def flush_out():
        with open(opath, "w") as fh:
            json.dump(out, fh, indent=1)

    for stage in args.stages.split(","):
        if stage == "seq":
            entry = score_seq_stage(cfg, scene, dev)
        else:
            entry = score_stage(stage, cfg, scene, model, tex, params,
                                ceilings_fn, args.n_views, dev)
        if entry:
            out[stage] = entry
            flush_out()
            print(f"[{stage}] {entry}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
