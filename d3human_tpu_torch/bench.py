"""The port's benchmark (counterpart of the repository's ``bench.py``): the
iterations a second of one stage's training step at the reference scale
(f3c: 128^3 G-Shell lattice, 1080^2 render, 6x256 Softplus SDF MLP,
hash-grid texture) on one card.

    python -m d3human_tpu_torch.bench [--device cuda|cpu]

Prints ONE JSON line on stdout, ``{"metric", "value", "unit",
"vs_baseline"}``, the JAX bench's keys and metric string; everything else
goes to stderr, among it one ``# kernels {...}`` line: the device and the
calls and launches of each kernel wrapper over the timed loop.

The JAX bench's environment variables, with its defaults:

  BENCH_SCALE       full | medium | small | seq[:full|medium|small]
  BENCH_STAGE       init | split (BENCH_SCALE=seq times the seq stage)
  BENCH_WARMUP      untimed steps before the timed loop (3)
  BENCH_ITERS       timed steps (20)
  BENCH_COV         render.max_covered_frac (0.25)
  BENCH_SHADING     on | off: render.init_shading (the config's default)
  BENCH_BF16        1: field.use_bfloat16
  BENCH_JITTER      n > 0: render.jitter_subsample
  BENCH_PERC        none | pyramid | conv: the perceptual backbone
  BENCH_NO_EIK      1: no eikonal term
  BENCH_NO_MSDFREG  1: no mesh-mSDF regularisers
  BENCH_NO_AA       1: the sparse antialias returns its input
  BENCH_FWDONLY     1: the loss tick alone (no backward, no optimizer)
  BENCH_SDF_CHUNK   geometry.sdf_chunk (0: one unchunked pass)
  BENCH_GRID_CROP   lattice crop margin around the template (0.1; 0: none)
  BENCH_SDF_SEED_STEPS  Adam steps fitting the SDF to the capsule (400)
  BENCH_SEQ_FACES   the seq template's face budget at full scale (415,000)
  BENCH_SEQ_STATICW 1: skinning weights transferred once at the template

A step is timed on the host's clock from a ``torch.cuda.synchronize()``
after the warm-up to one after the last timed step, and no metric is read
inside that loop. A scale that fails fails the run: it exits non-zero with
its traceback and prints no value line (no smaller scale is tried).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import torch

from d3human_tpu_torch import DEFAULT_DEVICE
from d3human_tpu_torch.ops.cuda_lib import read_counts, reset_counts

# The JAX bench's documented engineering estimates of the reference on one
# V100 at the same configurations (BASELINE.md: the reference publishes no
# timings). They are neither a measurement of this port nor of a TPU.
REFERENCE_ITERS_PER_SEC = 3.0
SEQ_REFERENCE_ITERS_PER_SEC = 5.0

# (render resolution, lattice resolution, max_verts, max_tets)
SCALES = {"full": ((1080, 1080), 128, 2 ** 18, 196608),
          "medium": ((720, 720), 96, 2 ** 17, 2 ** 17),
          "small": ((256, 256), 32, 2 ** 14, 2 ** 14)}
# (render resolution, midpoint subdivisions of the body); the full scale's
# template is then cluster-decimated to BENCH_SEQ_FACES
SEQ_SCALES = {"full": ((1080, 1080), 5), "medium": ((720, 720), 3),
              "small": ((256, 256), 2)}
GRID_BOUNDS = ((-0.6, -0.8, -0.4), (0.6, 0.8, 0.4))
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "tet_cache")
# the random draws of step i come from a generator seeded (KEY << 32) + i
# in the warm-up and (KEY << 32) + 100 + i in the timed loop: the JAX
# bench's fold_in(PRNGKey(42), i) and fold_in(PRNGKey(42), 100 + i)
KEY = 42
# the kernels every step of each bench stage launches
REQUIRED = ("first_k_indices", "coo_scatter_add", "resolve_tiles")


def _env(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def _scale(scale: str, table: dict):
    if scale not in table:
        raise ValueError(f"bench scale {scale!r}: one of {sorted(table)}")
    return table[scale]


def _camera(scene, res) -> None:
    """The bench camera at the bench resolution (JAX bench.py:195-202)."""
    import numpy as np

    from d3human_tpu_torch.render.camera import look_at, perspective

    dev = scene.mvp.device
    mvm = look_at(eye=(0.0, 0.0, 2.2), center=(0.0, 0.0, 0.0))
    proj = perspective(fovy=0.9, aspect=1.0)
    scene.mvp = torch.as_tensor(np.asarray(proj @ mvm, np.float32)).to(dev)
    scene.campos = torch.as_tensor(
        np.asarray(np.linalg.inv(mvm)[:3, 3], np.float32)).to(dev)
    scene.resolution = res


def _params(cfg, gparams, scene, tex, device) -> dict:
    from d3human_tpu_torch.render.light import create_trainable_env

    return {"geometry": gparams, "pose": scene.pose_params,
            "material": tex.init(torch.Generator().manual_seed(1)),
            "light": create_trainable_env(torch.Generator().manual_seed(2),
                                          cfg.render.probe_res,
                                          device=device)}


def build(scale: str, device=DEFAULT_DEVICE, cache_dir: str = CACHE_DIR):
    """(state, step_fn, target, extras) of the init or split bench
    (``BENCH_STAGE``) at ``scale``: the JAX bench's config, its scene, its
    lattice cropped to the template box + ``BENCH_GRID_CROP`` (cached in
    ``cache_dir`` in the JAX package's layout), the SDF fitted to a capsule
    and the mSDF cut at mid height, and its disc target.
    ``step_fn(state, target, generator)`` -> (state, metrics)."""
    from d3human_tpu_torch.config import (
        Config, FieldConfig, GeometryConfig, LossConfig, RenderConfig,
        StageConfig,
    )
    from d3human_tpu_torch.data.synthetic import (
        capsule_sdf, disc_target, make_scene,
    )
    from d3human_tpu_torch.models.geometry import GeometryModel
    from d3human_tpu_torch.models.perceptual import make_perceptual
    from d3human_tpu_torch.models.texture import MLPTexture3D
    from d3human_tpu_torch.ops.tet_grid import make_tet_grid, template_crop_box
    from d3human_tpu_torch.train.step import (
        init_state, make_train_step, stage_tick,
    )

    res, grid_res, mv, mt = _scale(scale, SCALES)
    shading = (_env("BENCH_SHADING") != "off" if _env("BENCH_SHADING")
               else Config().render.init_shading)
    render_kw = dict(train_res=res, texture_res=res, init_shading=shading,
                     max_covered_frac=float(_env("BENCH_COV", "0.25")))
    if int(_env("BENCH_JITTER", "0") or "0"):
        render_kw["jitter_subsample"] = int(_env("BENCH_JITTER"))
    loss_kw = {}
    if _env("BENCH_PERC"):
        loss_kw["perceptual_backbone"] = _env("BENCH_PERC")
    if _env("BENCH_NO_EIK", "0") == "1":
        loss_kw["use_eikonal"] = False
    if _env("BENCH_NO_MSDFREG", "0") == "1":
        loss_kw["use_mesh_msdf_reg"] = False
    geo_kw = {"sdf_chunk": 0}
    if _env("BENCH_SDF_CHUNK") != "":
        geo_kw["sdf_chunk"] = int(_env("BENCH_SDF_CHUNK"))
    cfg = Config(
        field=FieldConfig(use_bfloat16=_env("BENCH_BF16", "0") == "1"),
        geometry=GeometryConfig(grid_res=grid_res, max_verts=mv,
                                max_tets=mt, **geo_kw),
        render=RenderConfig(**render_kw),
        loss=LossConfig(**loss_kw),
        stages=StageConfig(init_epoch=2001),
    )
    scene = make_scene(resolution=(64, 64), n_frames=2, device=device)
    _camera(scene, res)

    crop_m = float(_env("BENCH_GRID_CROP") or "0.1")
    crop_box, crop_tag = None, ""
    if crop_m > 0:
        crop_box = template_crop_box(scene.canon.vs_template[0].cpu().numpy(),
                                     crop_m)
        crop_tag = f"_crop{crop_m:g}"
    grid = make_tet_grid(res=grid_res, bounds=GRID_BOUNDS, y_offset=0.0,
                         scale=1.0, crop_box=crop_box, device=device,
                         cache_path=os.path.join(
                             cache_dir, f"grid_{grid_res}{crop_tag}.npz"))
    if crop_box is not None:
        print(f"[bench] grid crop {grid.dims} of {grid_res}^3 "
              f"({grid.n_tets} tets)", file=sys.stderr, flush=True)
    model = GeometryModel(cfg, grid, scene.deformer, scene.canon)
    # a real surface: an empty mesh would skip the pixel path (the exact
    # compactions price what is rendered), so the SDF MLP is fitted to a
    # capsule at about a tenth of the frame and the mSDF cut at mid height
    gparams = model.init_params(torch.Generator().manual_seed(0), n_images=2)
    gparams, ploss = model.pretrain_sdf(
        gparams, capsule_sdf(grid.verts),
        steps=int(_env("BENCH_SDF_SEED_STEPS", "400")))
    gparams["msdf"] = torch.clamp(grid.verts[:, 1] * 4.0, -1.0, 1.0)
    print(f"[bench] seeded capsule surface (pretrain loss {ploss:.2e})",
          file=sys.stderr, flush=True)
    tex = MLPTexture3D(cfg.texture, ([0.0] * 6, [1.0] * 6), device)
    perceptual, perc_params = make_perceptual(cfg.loss.perceptual_backbone,
                                              device)
    params = _params(cfg, gparams, scene, tex, device)

    stage = _env("BENCH_STAGE", "init")
    if stage not in ("init", "split"):
        raise ValueError(f"BENCH_STAGE={stage!r}: init or split "
                         "(BENCH_SCALE=seq times the seq stage)")
    if _env("BENCH_NO_AA", "0") == "1":
        from d3human_tpu_torch.render import pipeline as _pl

        _pl.apply_aa_sparse = lambda img, pairs: img
    step_fn = make_train_step(stage, model, tex, perceptual, perc_params,
                              cfg)
    if _env("BENCH_FWDONLY", "0") == "1":
        # the loss tick alone: autograd stays on for the eikonal's inner
        # gradient, but nothing takes the total's backward

        def step_fn(state, target, generator=None, draws=None):
            out = stage_tick(stage, model, tex, perceptual, perc_params,
                             state.params, target, state.step, cfg,
                             generator=generator, draws=draws)
            return state, {k: v.detach() if isinstance(v, torch.Tensor)
                           else v for k, v in out.items()}

    state = init_state(stage, params, cfg)
    target = disc_target(res, scene.mvp, scene.campos, device)
    if stage != "split":
        target = {k: v for k, v in target.items()
                  if not k.startswith(("cloth_", "body_"))}
    extras = {"model": model, "tex": tex, "perceptual": perceptual,
              "perc_params": perc_params, "cfg": cfg, "stage": stage,
              "grid_crop": crop_m, "scene": scene}
    return state, step_fn, target, extras


def build_seq(scale: str, device=DEFAULT_DEVICE):
    """(state, step_fn, target, extras) of the seq bench at ``scale``: the
    body subdivided at edge midpoints to the template's scale (at full,
    cluster-decimated to ``BENCH_SEQ_FACES``), faces labelled by height,
    the default render config at the bench resolution, and frame 0's
    ground truth from the oracle rasterizer."""
    from d3human_tpu_torch.config import (
        Config, GeometryConfig, RenderConfig, StageConfig,
    )
    from d3human_tpu_torch.data.synthetic import (
        make_scene, seq_bench_template,
    )
    from d3human_tpu_torch.models.geometry import GeometryModel
    from d3human_tpu_torch.models.perceptual import ConvPerceptual
    from d3human_tpu_torch.models.texture import MLPTexture3D
    from d3human_tpu_torch.ops.tet_grid import make_tet_grid
    from d3human_tpu_torch.train.step import init_state, make_train_step

    res, n_subdiv = _scale(scale, SEQ_SCALES)
    target_faces = (int(_env("BENCH_SEQ_FACES", "415000"))
                    if scale == "full" else None)
    cfg = Config(
        geometry=GeometryConfig(grid_res=16, max_verts=2 ** 12,
                                max_tets=2 ** 12),
        render=RenderConfig(train_res=res, texture_res=res),
        stages=StageConfig(
            seq_static_skin_weights=_env("BENCH_SEQ_STATICW", "0") == "1"),
    )
    scene = make_scene(resolution=(64, 64), n_frames=2, device=device)
    _camera(scene, res)
    template = seq_bench_template(scene, n_subdiv=n_subdiv,
                                  target_faces=target_faces, device=device)
    print(f"# seq bench template: {template.v.shape[0]} verts, "
          f"{template.f.shape[0]} faces", file=sys.stderr, flush=True)
    grid = make_tet_grid(res=16, bounds=GRID_BOUNDS, y_offset=0.0,
                         scale=1.0, device=device)
    model = GeometryModel(cfg, grid, scene.deformer, scene.canon)
    if cfg.stages.seq_static_skin_weights:
        template = dataclasses.replace(
            template, w_pts=model.static_skin_weights(template.v))
    gparams = model.init_params(torch.Generator().manual_seed(0), n_images=2)
    tex = MLPTexture3D(cfg.texture, ([0.0] * 6, [1.0] * 6), device)
    perceptual = ConvPerceptual()
    perc_params = perceptual.init(device)
    params = _params(cfg, gparams, scene, tex, device)
    step_fn = make_train_step("seq", model, tex, perceptual, perc_params,
                              cfg, template=template)
    state = init_state("seq", params, cfg)
    extras = {"model": model, "tex": tex, "perceptual": perceptual,
              "perc_params": perc_params, "cfg": cfg, "stage": "seq",
              "template": template, "scene": scene}
    return state, step_fn, scene.frame_target(0), extras


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _generators(device: torch.device, first: int, n: int) -> list:
    return [torch.Generator(device=device).manual_seed((KEY << 32) + first + i)
            for i in range(n)]


def run(state, step_fn, target, device: torch.device, warmup: int,
        iters: int):
    """``warmup`` steps, then ``iters`` timed steps. Returns (state, the
    last step's metrics, seconds of the warm-up and of the timed loop,
    kernel counts of the timed loop)."""
    metrics = None
    t0 = time.perf_counter()
    for gen in _generators(device, 0, warmup):
        state, metrics = step_fn(state, target, gen)
    gens = _generators(device, 100, iters)
    _sync(device)
    reset_counts()
    t1 = time.perf_counter()
    for gen in gens:
        state, metrics = step_fn(state, target, gen)
    _sync(device)
    t2 = time.perf_counter()
    return state, metrics, (t1 - t0, t2 - t1), read_counts()


def _scalars(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def kernel_line(device: torch.device, iters: int, counts: dict,
                metrics: dict, seconds: dict) -> dict:
    """The stderr record of the timed loop: the device, each kernel's
    launches and calls, the longest tile list of the last step (the
    JAX package's binning cuts a list at 896 faces; the port's cuts
    none) and the seconds of the build, the warm-up and the timed
    loop."""
    if device.type == "cuda":
        kind, count = (torch.cuda.get_device_name(device),
                       torch.cuda.device_count())
    else:
        kind, count = "cpu", 1
    nmt = [v for k, v in metrics.items() if k.endswith("n_max_tile")]
    return {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": kind, "count": count, "iters": iters,
            "launches": {k: v for k, v in counts.items() if k != "calls"},
            "calls": counts["calls"], "n_max_tile": max(nmt, default=None),
            "seconds": seconds}


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def measure(scale: str, device: torch.device, warmup: int, iters: int):
    """(the value line, the kernel record) of one bench run."""
    t0 = time.perf_counter()
    if scale.startswith("seq"):
        sub = scale.split(":")[1] if ":" in scale else "full"
        state, step_fn, target, extras = build_seq(sub, device)
        stage, baseline = "seq", SEQ_REFERENCE_ITERS_PER_SEC
    else:
        state, step_fn, target, extras = build(scale, device)
        stage = extras["stage"]
        # split runs both halves an iteration, so the estimate halves
        baseline = REFERENCE_ITERS_PER_SEC / (2.0 if stage == "split"
                                              else 1.0)
    _sync(device)
    build_s = time.perf_counter() - t0
    state, metrics, (warm_s, timed_s), counts = run(
        state, step_fn, target, device, warmup, iters)
    ips = iters / timed_s
    metrics = _scalars(metrics)
    record = kernel_line(device, iters, counts, metrics, dict(
        build=build_s, warmup=warm_s, timed=timed_s))
    if device.type == "cuda":
        for k in REQUIRED:
            _require(counts[k] > 0, f"{k}: no launch in the timed loop")
    if stage == "seq":
        static = _env("BENCH_SEQ_STATICW") == "1"
        metric = (f"seq-stage train iters/sec ({sub} scale: "
                  + ("static-skin-weights; " if static else "")
                  + "subdivided template, raster res per config)")
    else:
        cfg = extras["cfg"]
        sh = ("" if stage != "init" else
              "; init_shading=on" if cfg.render.init_shading
              else "; init_shading=off (log-only term skipped, "
                   "gradients identical)")
        if extras["grid_crop"]:
            sh += (f"; grid_crop={extras['grid_crop']} "
                   f"(body-tight lattice, extraction-identical subset)")
        cov_vals = [v for k, v in metrics.items() if k.endswith("cap_cov")]
        cov_used = max(cov_vals, default=0.0)
        _require(cov_used < 1.0,
                 f"covered-pixel capacity overflow (cap_cov={cov_used:.2f})")
        # an empty surface renders nothing, and the exact compactions then
        # skip the pixel path: no hollow throughput number
        _require(not cov_vals or cov_used > 0.0,
                 "bench scene rendered nothing (empty surface)")
        sh += (f"; max_covered_frac={cfg.render.max_covered_frac}"
               f" (exact: peak occupancy {cov_used:.2f})")
        metric = (f"{stage}-stage train iters/sec ({scale} scale: "
                  f"grid^3 + raster res per config{sh})")
    line = {"metric": metric, "value": round(ips, 3), "unit": "iters/sec",
            "vs_baseline": round(ips / baseline, 3)}
    return line, record


def main(argv=None) -> int:
    from d3human_tpu_torch.utils.backend import device_or_exit

    ap = argparse.ArgumentParser(prog="python -m d3human_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default; without a card the run stops) or "
                         "cpu")
    args = ap.parse_args(argv)
    device = device_or_exit("bench", args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    scale = _env("BENCH_SCALE", "full")
    warmup = int(_env("BENCH_WARMUP", "3"))
    iters = int(_env("BENCH_ITERS", "20"))
    _require(iters > 0, f"BENCH_ITERS={iters}: at least one timed step")
    # stdout carries the value line alone
    with contextlib.redirect_stdout(sys.stderr):
        line, record = measure(scale, device, warmup, iters)
    print("# kernels " + json.dumps(record), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
