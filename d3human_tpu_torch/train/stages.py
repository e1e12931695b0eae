"""Stage drivers (counterpart of ``d3human_tpu/train/stages.py``): the
loop of the init, split and split_smpl stages (``run_stage``), the serial
per-frame seq loop (``run_seq_stage``), the frame-parallel seq stage
(``run_seq_stage_parallel``), and the stage artifacts
(``export_stage_meshes``, the visible-triangle sets). Checkpoints, scalar
logs, validation strips and meshes land under the stage's directory in
the JAX package's file layout.

Each iteration draws its random numbers from a generator seeded by
``fold_in(stage seed, iteration)`` (the counterpart of
``jax.random.fold_in(key, it)``), never from one running stream, so a
resumed run replays the draws. Inside an iteration nothing reads the
device back: the host waits for it only in ``StepTimer.flush`` (every
``SYNC_EVERY`` iterations) and at the log, checkpoint and validation
points.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from d3human_tpu_torch.config import Config
from d3human_tpu_torch.models.geometry import GeometryModel, SeqTemplate
from d3human_tpu_torch.ops.rasterizer import rasterize, xfm_points
from d3human_tpu_torch.train.checkpoint import load_state, save_state
from d3human_tpu_torch.train.step import TrainState
from d3human_tpu_torch.utils import io as mesh_io
from d3human_tpu_torch.utils.logging import ScalarLogger, StepTimer

SYNC_EVERY = 10          # iterations between two waits for the device
VALIDATE_TAG = 0x7FFFFFFF
SEQ_VALIDATE_TAG = 0x7EADBEE


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed from (seed, data), independent across ``data``."""
    return int(np.random.SeedSequence([seed & (2 ** 63 - 1), data])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def iteration_generator(seed: int, data: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(fold_in(seed, data))


def _scalars(metrics: Dict) -> Dict[str, float]:
    """The 0-d entries of ``metrics`` as floats, read back in one copy."""
    keys = [k for k, v in metrics.items()
            if isinstance(v, torch.Tensor) and v.dim() == 0]
    out = {k: float(v) for k, v in metrics.items()
           if isinstance(v, (int, float))}
    if keys:
        vals = torch.stack([metrics[k].detach().float() for k in keys]).cpu()
        out.update(zip(keys, vals.tolist()))
    return out


def _warn_absurd(stage: str, scalars: Dict[str, float]) -> None:
    """A loud warning for absurd loss scalars (a NaN, an overflow or a
    corrupted read-back)."""
    absurd = {k: v for k, v in scalars.items()
              if ("loss" in k or k == "total") and not (abs(v) < 1e9)}
    if absurd:
        print(f"[{stage}] WARNING: absurd loss scalars {absurd}: suspect "
              "corrupted readback or numerical blowup", flush=True)


def run_stage(stage: str, n_iters: int, state: TrainState, step_fn,
              next_target: Callable[[int], Dict], cfg: Config,
              save_path: str, seed: int,
              model: Optional[GeometryModel] = None, start_it: int = 0,
              tex_module=None) -> TrainState:
    """Iterations ``start_it .. n_iters - 1`` of one stage (ref
    optimize_mesh_init / split, train.py:651-833, :949-1243): log every
    ``log_interval``, a state in ``ckp/`` and (with ``model`` and
    ``tex_module``) a validation every ``save_checkpoint_interval``, then
    the final state, the final validation and
    ``validate/final_metrics.json``. A stage resumed past its end whose
    final metrics exist is returned as it is."""
    os.makedirs(save_path, exist_ok=True)
    logger = ScalarLogger(os.path.join(save_path, "loss_log"))
    timer = StepTimer()
    every = cfg.stages.save_checkpoint_interval
    dev = model.grid.verts.device if model is not None else "cpu"

    def maybe_validate(it):
        if tex_module is None or model is None:
            return None
        from d3human_tpu_torch.train.validate import (
            validate_split_stage, validate_stage,
        )
        from d3human_tpu_torch.utils.metrics import iou, psnr

        target = next_target(it)
        vdir = os.path.join(save_path, "validate")
        gen = iteration_generator(seed, VALIDATE_TAG, dev)
        if stage.startswith("split"):
            strip, metrics = validate_split_stage(
                gen, model, state.params, tex_module, target, cfg)
        else:
            strip, buffers = validate_stage(
                gen, model, state.params, tex_module, target, cfg,
                return_buffers=True)
            gt = target["all_img"]
            metrics = {
                "psnr": float(psnr(buffers.shaded[..., :3] * gt[..., 3:],
                                   gt[..., :3] * gt[..., 3:])),
                "mask_iou": float(iou(buffers.shaded[..., 3] > 0.5,
                                      gt[..., 3] > 0.5)),
            }
        mesh_io.save_image(os.path.join(vdir, f"img_pass1_{it:06d}.png"),
                           strip)
        logger.log(it, {f"val_{k}": v for k, v in metrics.items()})
        print(f"[{stage}] validate iter={it}: "
              + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
              flush=True)
        return metrics

    timer.start()
    for it in range(start_it, n_iters):
        target = next_target(it)
        state, aux = step_fn(state, target,
                             iteration_generator(seed, it, dev))
        timer.lap()
        if (it % SYNC_EVERY == 0 or it % cfg.stages.log_interval == 0
                or it == n_iters - 1):
            timer.flush(aux["total"])
        if it % cfg.stages.log_interval == 0:
            scalars = _scalars(aux)
            scalars["time_ms"] = timer.avg_ms
            logger.log(it, scalars)
            print(f"[{stage}] iter={it:5d} total={scalars['total']:.4f} "
                  f"time={timer.avg_ms:.1f}ms rem={timer.eta(n_iters - it)}",
                  flush=True)
            _warn_absurd(stage, scalars)
        if it % every == 0 and it != 0:
            save_state(os.path.join(save_path, "ckp", f"state_{it}.npz"),
                       state)
            maybe_validate(it)
    fm_path = os.path.join(save_path, "validate", "final_metrics.json")
    if start_it >= n_iters and os.path.exists(fm_path):
        print(f"[{stage}] resume: stage complete, reusing {fm_path}",
              flush=True)
        logger.close()
        return state
    save_state(os.path.join(save_path, "ckp", f"state_{n_iters - 1}.npz"),
               state)
    final_metrics = maybe_validate(n_iters - 1)
    if final_metrics is not None:
        with open(fm_path, "w") as fh:
            json.dump({"iter": n_iters - 1, **final_metrics}, fh)
    logger.close()
    return state


def export_stage_meshes(model: GeometryModel, params: Dict, save_path: str,
                        tag: str) -> Dict[str, str]:
    """Write ``split_{cloth,body}_imesh_<tag>.obj`` (the mSDF > 0 and < 0
    halves) and ``watertight_imesh_<tag>.obj`` (the SDF's closed surface)
    of ``params["geometry"]`` into ``save_path`` (ref train.py:977-989);
    returns their paths under ``cloth``, ``body`` and ``watertight``. The
    watertight mesh is the cloth extraction's watertight level: the JAX
    package extracts it a second time, with the same result."""
    out = {}
    with torch.no_grad():
        for name, sign in (("cloth", 1.0), ("body", -1.0)):
            mesh, _ = model.extract(params["geometry"], sign)
            out[name] = os.path.join(save_path,
                                     f"split_{name}_imesh_{tag}.obj")
            mesh_io.write_obj(out[name], *mesh_io.compact_mesh(
                mesh.verts, mesh.faces, mesh.face_valid))
            if name == "cloth":
                wt = mesh_io.compact_mesh(mesh.verts_wt, mesh.faces_wt,
                                          mesh.face_wt_valid)
    out["watertight"] = os.path.join(save_path,
                                     f"watertight_imesh_{tag}.obj")
    mesh_io.write_obj(out["watertight"], *wt)
    return out


def _make_visible_triangles_fn(cfg: Config):
    """(posed verts, faces, mvp) -> int32 [K] ids of the faces that win a
    pixel at the training resolution (ref train.py:1513-1519, collected at
    render/render.py:404-407); the binned rasterizer, no gradients."""

    def visible(v, f, mvp):
        with torch.no_grad():
            rast = rasterize(xfm_points(v, mvp), f,
                             torch.ones((f.shape[0],), dtype=torch.bool,
                                        device=v.device),
                             tuple(cfg.render.train_res))
        ids = np.unique(rast.tri_id.cpu().numpy())
        return (ids[ids > 0] - 1).astype(np.int32)

    return visible


def run_seq_stage(state: TrainState, step_fn, template: SeqTemplate,
                  frame_targets: Callable[[int], Dict], n_frames: int,
                  cfg: Config, save_path: str, seed: int,
                  model: GeometryModel, tex_module=None) -> TrainState:
    """The serial per-frame seq stage (ref train.py:1921-1926 and
    :1349-1352): frame 0 trains ``seq_iters_first`` iterations, each later
    frame ``seq_iters_rest`` from the frame before, up to
    ``seq_max_frames`` frames. Each frame writes ``delta/<frame>.npz``
    (the offsets and the visible triangles), ``fine_all_<frame>.ply``,
    with ``tex_module`` a validation strip and its metrics, then
    ``ckp/state_frame<frame>.npz``; states older than the frame before
    are pruned. A rerun resumes after the newest frame state."""
    os.makedirs(os.path.join(save_path, "delta"), exist_ok=True)
    ckp_dir = os.path.join(save_path, "ckp")
    os.makedirs(ckp_dir, exist_ok=True)
    n_frames = min(n_frames, cfg.stages.seq_max_frames)
    dev = model.grid.verts.device
    timer = StepTimer()
    logger = ScalarLogger(os.path.join(save_path, "loss_log"))
    visible_fn = _make_visible_triangles_fn(cfg)
    start_frame = 0
    for frame in range(n_frames - 1, -1, -1):
        p = os.path.join(ckp_dir, f"state_frame{frame}.npz")
        if os.path.exists(p):
            state = load_state(p, state)
            start_frame = frame + 1
            print(f"[seq] resume: frames 0..{frame} complete, starting at "
                  f"frame {start_frame}", flush=True)
            break
    for frame in range(start_frame, n_frames):
        iters = (cfg.stages.seq_iters_first if frame == 0
                 else cfg.stages.seq_iters_rest)
        target = frame_targets(frame)
        timer.start()
        for it in range(iters):
            state, aux = step_fn(state, target, iteration_generator(
                seed, frame * 100000 + it, dev))
            timer.lap()
            if it % SYNC_EVERY == 0 or it % cfg.stages.log_interval == 0 \
                    or it == iters - 1:
                timer.flush(aux["total"])
            if it % cfg.stages.log_interval == 0:
                scalars = _scalars(aux)
                scalars["time_ms"] = timer.avg_ms
                logger.log(frame * 100000 + it, scalars)
                print(f"[seq] frame={frame} iter={it:4d} "
                      f"total={scalars['total']:.4f} "
                      f"time={timer.avg_ms:.1f}ms", flush=True)
        with torch.no_grad():
            posed, delta = model.seq_deformed(
                state.params["geometry"], template, state.params["pose"],
                int(target["frame_idx"]))
        np.savez(os.path.join(save_path, "delta", f"{frame}.npz"),
                 delta=delta.cpu().numpy(),
                 visible_triangles=visible_fn(posed, template.f,
                                              target["mvp"]))
        mesh_io.write_ply(os.path.join(save_path, f"fine_all_{frame}.ply"),
                          posed, template.f)
        if tex_module is not None:
            from d3human_tpu_torch.train.validate import validate_seq_stage

            strip, metrics = validate_seq_stage(
                iteration_generator(seed, SEQ_VALIDATE_TAG + frame, dev),
                model, state.params, tex_module, template, target, cfg)
            mesh_io.save_image(os.path.join(
                save_path, "validate", f"seq_frame{frame:04d}.png"), strip)
            logger.log(frame * 100000 + iters,
                       {f"val_{k}": v for k, v in metrics.items()})
            print(f"[seq] validate frame={frame}: "
                  + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
                  flush=True)
        save_state(os.path.join(ckp_dir, f"state_frame{frame}.npz"), state)
        # resume reads only the newest frame state
        for old in range(frame - 1):
            op = os.path.join(ckp_dir, f"state_frame{old}.npz")
            if os.path.exists(op):
                os.remove(op)
    logger.close()
    return state


def run_seq_stage_parallel(params: Dict, template: SeqTemplate,
                           frame_targets: Callable[[int], Dict],
                           n_frames: int, cfg: Config, save_path: str,
                           seed: int, model: GeometryModel, tex_module,
                           perceptual, perc_params, n_devices: int = 0,
                           raster_opts: Optional[dict] = None):
    """The frame-parallel seq stage (counterpart of the JAX package's
    ``run_seq_stage_parallel``): every frame optimizes ``seq_iters_first``
    iterations from its own copy of ``params`` (``parallel/frames.py``),
    each rank its contiguous block of the frames, with no warm start from
    the frame before and no state saved mid-run (rerun on interruption).
    The frame axis is padded to a multiple of the world size; a padded
    slot re-optimizes the last frame and is dropped. Each rank writes its
    own real frames' ``delta/<f>.npz`` and ``fine_all_<f>.ply`` in the
    serial driver's format, rank 0 the ``loss_log`` at ``frame * 100000 +
    it`` every ``log_interval``; all ranks meet at a barrier at the end.
    Returns the runner's per-frame parameters."""
    # parallel/frames.py builds on this module's iteration_generator
    from d3human_tpu_torch.parallel.frames import make_parallel_seq_runner
    from d3human_tpu_torch.parallel.mesh import make_frame_mesh, shard_leading

    os.makedirs(os.path.join(save_path, "delta"), exist_ok=True)
    n_frames = min(n_frames, cfg.stages.seq_max_frames)
    n_iters = cfg.stages.seq_iters_first
    mesh = make_frame_mesh(n_devices or cfg.parallel.n_frame_shards,
                           axis=cfg.parallel.frames_axis,
                           device=model.grid.verts.device)
    n_pad = -(-n_frames // mesh.world) * mesh.world
    block = shard_leading(mesh, n_pad)
    targets = [frame_targets(min(f, n_frames - 1)) if f in block else None
               for f in range(n_pad)]
    launch, mesh = make_parallel_seq_runner(
        model, tex_module, perceptual, perc_params, template, cfg,
        n_frames=n_pad, n_iters=n_iters, mesh=mesh, raster_opts=raster_opts)
    if mesh.rank == 0:
        print(f"[seq-par] {n_frames} frames (+{n_pad - n_frames} pad) x "
              f"{n_iters} iters on {mesh.world} device(s)", flush=True)
    t0 = time.perf_counter()
    per_frame, totals = launch(params, targets, seed)
    wall = time.perf_counter() - t0
    if mesh.rank == 0:
        print(f"[seq-par] done in {wall:.1f}s ({wall / n_iters * 1000:.1f} "
              "ms/iter wall across all frames)", flush=True)
        logger = ScalarLogger(os.path.join(save_path, "loss_log"))
        for frame in range(n_frames):
            for it in range(0, n_iters, cfg.stages.log_interval):
                logger.log(frame * 100000 + it,
                           {"total": float(totals[frame, it])})
        logger.close()
    visible_fn = _make_visible_triangles_fn(cfg)
    for frame in block:
        if frame >= n_frames:
            continue
        p = per_frame[frame]
        target = targets[frame]
        with torch.no_grad():
            posed, delta = model.seq_deformed(
                p["geometry"], template, p["pose"], int(target["frame_idx"]))
        np.savez(os.path.join(save_path, "delta", f"{frame}.npz"),
                 delta=delta.cpu().numpy(),
                 visible_triangles=visible_fn(posed, template.f,
                                              target["mvp"]))
        mesh_io.write_ply(os.path.join(save_path, f"fine_all_{frame}.ply"),
                          posed, template.f)
        print(f"[seq-par] frame={frame} final total="
              f"{float(totals[frame, -1]):.4f}", flush=True)
    if mesh.group is not None:
        dist.barrier(group=mesh.cpu_group)
    return per_frame
