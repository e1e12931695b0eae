#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (d3human_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout. Phases, one JSON
object per line (``t``: the script's seconds when the phase ended):

  device       card name and power limit (nvidia-smi); exits non-zero
               without a CUDA device
  build        nvcc of every csrc/*.cu for sm_90a, all sources at once
  small        the port's init tick on a tiny scene on the card (kernels)
               against the same tick on the CPU (plain versions)
  small_split  the same for the split tick (both halves, shaded render,
               texture), same parameters and injected random draws
  small_seq    the same for the seq tick on a tiny template (the body
               subdivided once)
  small_pbr    render_mesh(bsdf="pbr") on the tiny scene's init mesh, card
               against CPU with the same draws: buffers abs 1e-5, the
               light's and the texture's gradients rel-L2 1e-4; without
               and with an analytic ball as the occluder
  small_bf16   the SDF MLP at the field config's width with
               field.use_bfloat16 (bf16 products, float32 accumulation) on
               16,384 points, card against CPU: output and gradients
               within rel-L2 2^-9 and the card's result the bf16 one (at
               least half the CPU's bf16-to-float32 distance from the
               float32 MLP); ms of a forward + backward in bf16 and f32
  scene        the full-width bench scene: 1080^2 pixels, 128^3 lattice
               cropped to the template box + 0.1, 2^18 / 196,608
               capacities, capsule-seeded SDF, mSDF cut at mid height,
               default hash-grid texture, split targets (JAX package:
               bench.py build("full"))
  field_setup  the field set-up between stages on a copy of the scene's
               parameters: the SMPL template's SDF at the lattice vertices
               (the tensor op, K=8) against the native engine at the same
               points (max abs 5e-3, signs equal where |sdf| > 0.01),
               FIELD_STEPS steps of pretrain_sdf to it and of
               pretrain_nonrigid_zero (ms per step; both losses fall),
               reinit_fields, and the SDF query chunked at
               geometry.sdf_chunk against the unchunked one over the lattice
               (forward rel 1e-6, sdf_net gradient rel-L2 1e-5; time and
               peak memory of both)
  seq_scene    the seq bench's merged template built from the port alone
               (the body midpoint-subdivided 5 times, cluster-decimated to
               at most 415,000 faces, faces labelled by height): vertex,
               face, cloth/body and adjacent-pair counts, build seconds;
               the seq config is the JAX package's bench.py
               build_seq("full"): default field, texture, render (1080^2,
               max_covered_frac 0.5) and loss configs, raster_opts None
  kernels      each kernel against its plain version on the scene's own
               inputs (the scan: the eikonal sampling's area CDF of the
               scene's extraction and the light probe's column CDFs,
               within 1e-6 of the largest prefix of torch.cumsum and bit
               for bit across two calls): first_k exactly equal at its five
               shapes, its two
               launches the only kernels of its calls (no library scan, no
               copy or cast) and its eager wrapper faster than
               torch.nonzero + pad; the scatter within rel 1e-5 /
               abs 1e-6 and bitwise equal across two runs; the tile resolve
               (without and with a depth-peel floor, every tile's whole
               list) exactly equal to its plain version and to its own
               second call, its (slot, tile) pairs counted on the device
               equal to the plain walk's and its share of the bound they
               give; the fields MLP's bias + softplus at a hidden layer
               and at the layer before the skip, at every grid vertex
               (forward bit for bit, backward within 1e-6, its bias
               gradient bit for bit across two calls); the fields MLP's
               products with the bias + softplus in their epilogue at the
               fit's shapes (the input layer, a hidden layer, the skip
               layer's rows of 295 padded to 296; the input gradient of a
               hidden and of the skip layer, and the output layer's rank-1
               one) and at the nonrigid DeformMLP's (its input layer of
               136 + 51 at the grid and at the seq template's cloth and
               body vertices, its skip layer, its 3-wide output layer's
               input gradient), within LS_TOL of the plain product and
               pass, each bit for bit across two calls. Time of the
               kernel's wrapper, of the plain version and
               of a library call computing the same function (CUDA events),
               and the wrapper's device time alone (CUDA-graph replays of
               one call; for first_k also of 20 calls back to back);
               first_k's count and write launches, and the scatter's key
               preparation + sort and sum kernels, from the profiler's
               kernel rows of the wrapper's own calls (the sort beside the
               plain version's torch.sort);
               the binning with and without the per-slot copy of the rows;
               then the same checks at the seq step's shapes (first_k on
               its covered-pixel mask, the scatter at the Laplacian's and
               the face-normal backward's shapes, the resolve on the seq
               template's binning), reported under "seq" in each row
  step         warm-up step, then INIT_STEPS timed init training steps
               (CUDA events) with every kernel launch count reset just
               before and read just after; losses finite, n_cross > 0,
               n_cov > 0, first_k exactly 5 calls (2 launches each) and the
               resolve 1 launch per step
  profile      one more init step under torch.profiler: device busy time,
               idle share, device ms launched inside each of the port's
               d3h.* ranges (d3h.geometry.extract among them), the
               nearest-neighbour searches' (query, reference) pairs
               (knn_pairs), top operators by device time, the port's
               kernels, the fields MLP's input and hidden layers on the
               fused path and on the other (mlp_layers: the grid query
               fused, the eikonal's not, 7 / 7 at the f3c width)
  profile      the same for FIT_PROFILE_STEPS steps of pretrain_sdf at
               every lattice vertex (the d3h.geometry.fit.* ranges)
  split_step   the same for SPLIT_STEPS split training steps: both halves
               non-empty, first_k exactly 8 calls and the resolve 2 per step
  validate     the split stage's validation render of both halves
               (render_stage_mesh(compact=False), layers = VAL_LAYERS):
               per half 2 resolve launches, 1 of them with a floor; layer 1
               covers fewer pixels than layer 0 and lies behind it
  profile      one more split step (mlp_layers 7 / 14: both halves'
               eikonals unfused; d3h.geometry.extract and
               d3h.smplx.skin_weights there), then one more validation render of
               the cloth half, under torch.profiler
  surgery      the JAX package's host route from the split stage to the
               seq template (train_d3h.py), on the split steps' parameters:
               export_stage_meshes, process_close_hole, the canonical
               template as smpl_template.obj, merge_body_cloth at
               grid_res min(96, geometry.grid_res), build_seq_template;
               seconds of each step, faces and verts of each half, the
               components moved, the body's faces at each step of the
               merge, merged faces < 2^20, both labels non-empty, the
               inside/outside body vertices and the branch that classified
               them, the native engine answering every host SDF query, and
               the launches and calls of first_k and the scatter
  surgery_kernels  first_k and the scatter at the surgery's own inputs
               (each call site's biggest call, recorded during the
               surgery), and the resolve on the surgery template's binning
               at the seq step's resolution, each held to its plain
               version as in the kernels phase; reported under "surgery"
               in each row
  surgery_seq_step  the same as seq_step for SURGERY_SEQ_STEPS seq steps
               on that template, on a copy of the parameters (the seq
               config of seq_scene)
  seq_step     the same for SEQ_STEPS seq training steps: first_k exactly
               3 calls, the resolve 1 per step, n_cov > 0, the offsets'
               loss > 0
  determinism  DET_STEPS init, split and seq steps from copies of the
               scene's parameters, twice in PyTorch's default mode with the
               same generators and once under deterministic(): every
               parameter, Adam moment and loss bit for bit across the
               three, no op warned; one validation half twice, every buffer
               bit for bit; step ms in both modes
  profile      one more seq step under torch.profiler (SEQ_RANGES there)
  seq_knn      the seq step's two nearest-neighbour searches alone (the
               collision's and the skinning-weight transfer's), timed
  parallel_seq the frame-parallel seq runner (parallel/frames.py) on a
               process group of one (NCCL, file store under PAR_DIR),
               PAR_FRAMES frames x PAR_ITERS iterations on the seq
               template: each frame's parameters and losses against a
               serial loop of make_train_step("seq") from the same shared
               parameters with a fresh optimizer and the same generators
               (bit for bit), the timed run (default mode) bit for bit the
               runner's run under deterministic(), the frames differ; wall
               seconds, ms an iteration a frame, peak memory, launches
  dp_step      make_dp_train_step of the init and the split stage at the
               scene's width, DP_BATCH examples on that group: the update
               against two loss_and_grads, their mean and one step of the
               DP step's own optimizer (clip 1.0, unscaled lr_pos) within
               rel-L2 1e-5; ms a DP step, peak memory
  parallel_kernels  the kernels at the calls recorded on parallel_seq and
               dp_step, as in cli_kernels; the rows' "parallel" entries
  parallel_world2  the runner (2 frames x 2 iterations on the seq
               template) and an init DP step (2 examples) on the full
               scene in two spawned processes sharing the card (gloo)
               against the same in this process (world 1), all with
               PyTorch's deterministic algorithms: bit for bit or rel-L2
               1e-6
  pbr          render_mesh(bsdf="pbr") on the scene's init mesh at 1080^2,
               the scene's 256^2 probe (scaled by a seeded field), 8 light
               samples: a warm-up whose kernel calls are recorded by call
               site, PBR_RENDERS forward + backward renders (extraction
               included; ms, peak memory; the light's and the texture's
               gradients finite and non-zero), a forward render without
               gradients, and one with the scene's SDF MLP as the occluder
               (positive at the body's centre; 149 M queries; seconds and
               peak memory): the shadow darkens pixels and lightens none
  pbr_kernels  first_k, the scatter and the resolve at the pbr warm-up's
               recorded calls, as in cli_kernels; the rows' "pbr" entries
  mobilenet    MOBILENET_STEPS init and split steps at full width with the
               MobileNetV2 backbone on its He-init weights (the checks of
               step and split_step, phases mobilenet_step and
               mobilenet_split_step), its features card vs CPU at the
               448^2 crop (rel-L2 1e-5 a tap), then per stage
               MOBILENET_STEPS turns of a conv-backbone step and a
               MobileNet step (CUDA events)
  aux          each API-only module once on the card against the CPU:
               edge_normal_consistency_loss on the scene's init extraction,
               antialias and the bilateral denoiser at 1080^2, the cubemap
               conversions and prefilters at 32^2 a face, CondBNDecoder,
               LPIPSLike on the 448^2 crop (values abs 1e-5 + rel 1e-5,
               gradients rel-L2 1e-3); on the host tetrahedralize_interior
               of the SMPL template and a material file's round trip
  aux_kernels  the kernels at the aux calls' recorded inputs; the rows'
               "aux" entries
  ref_grid     the scene's cropped lattice as an unstructured grid (its
               verts and tets, unique edges from the sort: only the edge
               order differs) against the lattice, on copies of the
               parameters: crossing-edge, valid-tet, face and covered-pixel
               counts exactly equal; INIT_STEPS init and SPLIT_STEPS split
               steps on each from the same state and generator, losses
               within rel 1e-5 and gradients within rel-L2 1e-4 a leaf,
               counters exact; the lattice's round trip through a
               reference-format npz (vertices / 1.2 with y + 0.1919,
               indices) read by load_reference_tet_grid: tets and edges
               equal, positions within 1e-7. Then (the scenes above freed)
               the uncropped 128^3 lattice, the reference file's extent
               (2,146,689 verts, 12,582,912 tets), built with the crop off
               (the SDF fitted to the capsule by REF_SEED_STEPS Adam
               steps), written and read back the same way (host seconds of the
               sort-based unique edges), INIT_STEPS init steps and one
               split step: step ms, peak memory, counts inside the
               capacities; kernel launches and calls of both runs' steps;
               on each grid the scatter at sdf_reg_loss's two
               endpoint-gather backwards (N = the edges, C = 1) held to
               its plain version as in the kernels phase
  ref_grid_kernels, ref_grid_uncropped_kernels  the kernels at the two
               runs' recorded calls (first_k on the unstructured masks),
               as in cli_kernels; the rows' "ref_grid" and
               "ref_grid_uncropped" entries, with the endpoint backwards
  gt_targets   the synthetic ground truth at 1080^2 (the scenes above are
               freed first): frame_target of 4 frames through the oracle
               rasterizer (plain PyTorch by design: no kernel), ms per
               frame and peak memory; the oracle's tri_id against the
               binned rasterizer's (the resolve kernel) on frame 0's body:
               coverage equal, ids equal on >= 99.9 % of covered pixels;
               CachedTargets against frame_target per buffer, abs 2e-3
  cli          the port's CLI in this process, main(argv): --synthetic
               --stages split_smpl,init,split,seq --device cuda on a copy
               of configs/f3c_synth_full20.json at full width with the
               cuts of CLI_SCALES["full"] (sdf_mlp_pretrain_steps 3000 ->
               100, sdf_deform_pretrain_steps 1000 -> 50), 4 synthetic
               frames and --iters-scale 0.002 (split_smpl 2, init 4,
               split 2, seq 2 + 3 x 2 steps), into a fresh out dir under
               CLI_DIR; kernel counts reset just before and read just
               after. Per stage: steps, seconds, step ms (CUDA events),
               ground-truth render ms, peak memory, kernel launches and
               calls, the logged losses (all finite) and validation
               metrics; PARITY.json; final_metrics.json of split_smpl,
               init and split, every seq frame's delta and ply, [done], and
               launches of first_k, the scatter and the resolve. Then the
               same command with --resume: no training step, the close
               hole and the merge reused, PARITY.json's entries kept.
               The first run's kernel calls are recorded by call site
               (the biggest call of each site; the resolve's by stage)
  cli_kernels  first_k and the scatter at each recorded call site's
               biggest call and the resolve at each stage's biggest
               binning (the seq stage's on the seq template), each held
               to its plain version as in surgery_kernels; reported under
               "cli" in each row
  cli_cut      the cli phase's command again into CLI_CUT_DIR, cut as the
               split's second step starts (CutRun from the instrumented
               step counter), then with --resume: every stage's final
               checkpoint leaf, every seq delta npz and fine_all ply and
               every PARITY.json number bit for bit the cli run's
  scorers      the port's scorers on the cli run's out dir: eval_parity
               with --n-views 4 --n-frames 4 (every stage's entry, the
               union's IoUs and the ceilings in (0, 1], the halves' IoUs in
               [0, 1], PSNR and Chamfers finite), then
               score_seq_partial (its Chamfers within rel 1e-6 of the cli
               run's own seq entry) and on a copy of the seq meshes less the
               last frame's (n_frames 3, the partial marker); seconds of
               each, the kernels' launches (path "scorers")
  bake         the port's bake entry point (d3human_tpu_torch.scripts.
               bake_texture) on the cli run's init checkpoint and
               watertight mesh at 2048^2, --atlas lscm and --atlas grid:
               faces, charts, the unwrap's seconds (host), the bake's,
               the UV rasterization and the texture lookups timed alone,
               the files; render_uv at 256^2 on the card equal to the
               CPU's (masks exact, kd / ks abs 1e-5)
  cli_parallel the CLI with --stages seq --seq-parallel and the cli
               phase's other arguments on a copy of its out dir (seq/
               removed): every frame's delta npz with the serial run's
               keys and offsets' shape, its ply with the serial run's
               counts, the loss_log at frame * 100000 + it, the kernels
               launched
  capture_export  the port's exporter (d3human_tpu_torch.scripts.
               export_reference_layout) writes the synthetic scene in the
               reference's capture layout at 1080^2, 4 frames, under
               CAPTURE_DIR: seconds, files, bytes
  capture_data FrameDataset on that layout: per frame the host decode
               and the device preprocessing (ms), the targets against the
               scene's frame_target under the exporter's camera within the
               JAX round-trip bounds (mvp 1e-4, mask IoU > 0.99, rgb 0.02,
               normals 0.05); frame 0 at the camera's own 2160^2 (each
               pixel a 2x2 block that averages to it): host decode and
               device preprocessing (ms), targets equal to frame 0's and
               the 2x resize on the card equal to the CPU's; load_image exactly equal on frame 0's RGB
               image re-encoded with each scanline filter 0-4 and with one
               per row (ms a decode); the frame cache read through the
               native library within 2e-3 of frame_target (ms a frame,
               MiB); a seeded body model in the official SMPL-X npz layout
               at SMPL-X's widths (10,475 verts, 20,908 faces, 55 joints,
               shapedirs [V, 3, 400], posedirs [V, 3, 486]):
               load_smplx_npz and forward on the card against the CPU
               within rel 1e-5, and the canonical weight transfer of the
               CLI's 441,180-vertex lattice, timed
  capture_cli  the cli phase's command without --synthetic, on that
               layout (--trainset_path CAPTURE_DIR --folder_name
               neutral-synth): the same checks (no --resume run), per
               stage also the data ms an iteration (frame_target, not the
               background composited after it) on CUDA events and on the
               host's clock, and the host decode ms; PARITY.json without
               Chamfer; the first run's kernel calls recorded by call site
  capture_kernels  the cli_kernels checks at the capture run's calls;
               reported under "capture" in each row
  bench        with every scene freed (the card's free memory on a
               bench_memory line first), the port's bench entry point as a
               user runs it, python -m d3human_tpu_torch.bench in a
               subprocess, three times at the full scale with its default
               warm-up and timed steps: BENCH_STAGE=init, BENCH_STAGE=split
               and BENCH_SCALE=seq:full; per run the value line it printed
               (exactly one line with the JAX bench's four keys, value > 0),
               its ms a step, its stderr kernel line, its seconds and the
               peak occupancy of its metric string; each run's kernel calls
               a timed step those of the stage's step phase (STEP_CALLS, the
               scatter launched) and its ms a step within BENCH_MS_RATIO of
               that phase's mean in this run (a bench that timed the
               enqueue fails); a run that exits non-zero prints the tail of
               its stderr and fails the script

Then the kernel table, the nvidia-smi line, and the result line
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero and prints no result.

    python3 chip_smoke.py --kernels-only

stops after the kernels phase (a short check of a changed kernel): it
prints the kernel table without launch counts and no result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12     # FP32 outside the tensor cores
INIT_STEPS = 2                 # timed init steps after the warm-up step
SPLIT_STEPS = 4                # timed split steps after the warm-up step
SEQ_STEPS = 4                  # timed seq steps after the warm-up step
SURGERY_SEQ_STEPS = 2          # timed seq steps on the surgery's template
FIELD_STEPS = 30               # Adam steps of each field pretraining
SEED_STEPS = 400               # Adam steps fitting the SDF to the capsule
VAL_LAYERS = 2                 # depth-peeled layers of the validation render
FIT_PROFILE_STEPS = 10         # Adam steps of the profiled SDF fit
PROFILE_TRACE = "d3human_tpu_torch/build/smoke_profile/trace.json"
MOBILENET_STEPS = 3            # timed steps a stage with the MobileNetV2 loss
AUX_DIR = "d3human_tpu_torch/build/smoke_aux"
EXACT = ("n_cross", "n_valid_tets", "n_big_faces", "n_max_tile")
# the training state of each stage in the scene dict, and its step's phase
STATE_KEY = {"init": "state", "split": "split_state", "seq": "seq_state"}
STEP_PHASE = {"init": "step", "split": "split_step", "seq": "seq_step"}


T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """A phase's JSON line; ``t`` is the script's seconds so far."""
    print(json.dumps({"phase": phase, "t": time.perf_counter() - T0, **kw}),
          flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------- scenes

SCALES = {
    # the JAX package's bench.py build("full") with
    # configs/f3c_synth_full20.json's capacities, crop and optimizer
    "full": dict(res=(1080, 1080), grid_res=128, mv=2 ** 18, mt=196608,
                 n_eik=50000, cov=0.25, crop=448, raster_opts=None,
                 # bench.py build_seq("full")
                 seq=dict(n_subdiv=5, target_faces=415000, cov=0.5),
                 # the JAX package's default geometry.sdf_chunk
                 sdf_chunk=131072),
    # a CPU-sized rehearsal of the same paths
    "tiny": dict(res=(32, 32), grid_res=8, mv=2048, mt=2048, n_eik=256,
                 cov=0.9, crop=24, raster_opts=dict(
                     tile=(8, 16), bin_expand=8),
                 seq=dict(n_subdiv=1, target_faces=None, cov=0.9),
                 sdf_chunk=100),
}


def build_scene(scale: str, device: str, seed_steps: int, crop: bool = True):
    """Config, model, texture, perceptual, targets and the train states of
    the bench scene, from the port alone. ``seed_steps`` Adam steps fit the
    SDF MLP to an analytic capsule so the lattice holds a real surface; the
    mSDF is cut at mid height so both split halves carry faces. The init
    and the split state share one parameter tree (steps update in place).
    ``crop`` False keeps the whole lattice (the reference grid's extent)."""
    import torch

    from d3human_tpu_torch.config import (
        Config, GeometryConfig, LossConfig, OptimConfig, RenderConfig,
    )
    from d3human_tpu_torch.data.synthetic import (
        capsule_sdf, disc_target, make_scene,
    )
    from d3human_tpu_torch.models.geometry import GeometryModel
    from d3human_tpu_torch.models.perceptual import ConvPerceptual
    from d3human_tpu_torch.models.texture import MLPTexture3D
    from d3human_tpu_torch.ops.tet_grid import make_tet_grid, template_crop_box
    from d3human_tpu_torch.render.light import create_trainable_env
    from d3human_tpu_torch.train.step import init_state

    s = SCALES[scale]
    cfg = Config(
        geometry=GeometryConfig(grid_res=s["grid_res"], grid_crop=0.1,
                                max_verts=s["mv"], max_tets=s["mt"],
                                n_eikonal_samples=s["n_eik"], sdf_chunk=0),
        render=RenderConfig(train_res=s["res"], init_shading=False,
                            max_covered_frac=s["cov"]),
        loss=LossConfig(perceptual_crop=s["crop"]),
        optim=OptimConfig(clip_max_norm=1.0, init_lr_scale=0.1),
    )
    scene = make_scene(resolution=(64, 64), n_frames=2, device=device)
    box = template_crop_box(scene.canon.vs_template[0].cpu().numpy(),
                            cfg.geometry.grid_crop) if crop else None
    grid = make_tet_grid(res=cfg.geometry.grid_res,
                         bounds=((-0.6, -0.8, -0.4), (0.6, 0.8, 0.4)),
                         y_offset=0.0, scale=1.0, crop_box=box,
                         device=device)
    model = GeometryModel(cfg, grid, scene.deformer, scene.canon)
    gparams = model.init_params(torch.Generator().manual_seed(0),
                                n_images=2)
    ploss = float("nan")
    if seed_steps:
        gparams, ploss = model.pretrain_sdf(gparams, capsule_sdf(grid.verts),
                                            steps=seed_steps)
    gparams["msdf"] = torch.clamp(grid.verts[:, 1] * 4.0, -1.0, 1.0)
    tex = MLPTexture3D(cfg.texture, ([0.0] * 6, [1.0] * 6), device)
    perceptual = ConvPerceptual()
    gen = torch.Generator().manual_seed(1)
    params = {"geometry": gparams, "pose": scene.pose_params,
              "material": tex.init(gen),
              "light": create_trainable_env(gen, cfg.render.probe_res,
                                            device=device)}
    return dict(cfg=cfg, model=model, tex=tex, perceptual=perceptual,
                scene=scene,
                perc_params=perceptual.init(device), params=params,
                target=disc_target(cfg.render.train_res, scene.mvp,
                                   scene.campos, device),
                state=init_state("init", params, cfg),
                split_state=init_state("split", params, cfg),
                raster_opts=s["raster_opts"], pretrain_loss=ploss,
                grid_dims=grid.dims, n_verts=grid.n_verts,
                n_tets=grid.n_tets, n_edges=grid.n_edges)


def add_seq(sc: dict, scale: str) -> dict:
    """The seq stage on the scene: its merged template (built on the host
    from the port alone), its config and its train state, which shares the
    scene's parameter tree. Returns the template's counts."""
    import numpy as np
    import torch

    from d3human_tpu_torch.config import Config, RenderConfig
    from d3human_tpu_torch.data.synthetic import seq_bench_template
    from d3human_tpu_torch.train.step import init_state

    s = SCALES[scale]["seq"]
    dev = sc["model"].grid.verts.device
    t0 = time.perf_counter()
    template = seq_bench_template(sc["scene"], n_subdiv=s["n_subdiv"],
                                  target_faces=s["target_faces"], device=dev)
    build_s = time.perf_counter() - t0
    cfg = Config(render=RenderConfig(train_res=sc["cfg"].render.train_res,
                                     max_covered_frac=s["cov"]))
    sc.update(seq_template=template, seq_cfg=cfg,
              seq_state=init_state("seq", sc["params"], cfg))
    lab = template.face_labels.cpu().numpy()
    return dict(build_seconds=build_s, n_verts=int(template.v.shape[0]),
                n_faces=int(template.f.shape[0]),
                cloth_faces=int(np.sum(lab == 1)),
                body_faces=int(np.sum(lab == 0)),
                cloth_verts=int(template.cloth_vidx.shape[0]),
                body_verts=int(template.body_vidx.shape[0]),
                adjacent_pairs=int(template.connected_faces.shape[0]))


def tick_draws(cfg, stage: str, seed: int):
    """Every random number one tick of ``stage`` draws, made on the CPU from
    ``seed``, in the layout the ticks take as ``draws``: so the card and the
    CPU run of one tick see the same numbers."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    H, W = cfg.render.train_res
    n_sub = -(-int(H * W * cfg.render.max_covered_frac)
              // cfg.render.jitter_subsample)
    n = cfg.geometry.n_eikonal_samples
    crop = cfg.loss.perceptual_crop

    def one():
        return {
            "eik": (torch.rand((n,), generator=gen),
                    torch.rand((n, 2), generator=gen)),
            "render": (torch.randn((n_sub, 3), generator=gen),
                       torch.randn((n_sub, 2), generator=gen)),
            "crop": tuple(int(torch.randint(0, max(d - crop, 1), (),
                                            generator=gen)) for d in (H, W))}

    if stage == "init":
        return one()
    if stage == "seq":
        return {"render": one()["render"]}
    return {"cloth": one(), "body": one()}


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def scalars(metrics: dict) -> dict:
    return {k: float(v.detach()) for k, v in metrics.items()}


# ---------------------------------------------------------------- checks

def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, calls: int = 1) -> float:
    """Device time of ``fn``'s launches alone: ``calls`` calls captured once
    into a CUDA graph and replayed, so no host time between its launches
    counts (a wrapper that takes the host longer to call than the card to
    run reads the host's time under ``cuda_ms``); per call. With one call
    a replay's own start is in the time."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, reps=reps) / calls


# seconds of host idle on each side of the calls in parts_ms' traces, one
# entry a try: the profiler keeps only device rows that fall inside its
# window on its clock, and a short window loses rows to a small offset
# between the host's and the card's timestamps
PARTS_PAD_S = (0.0, 0.05, 0.25, 1.0)


def parts_ms(fn, parts: dict, need=None, reps: int = 5) -> dict:
    """Device time per call of ``fn`` by part, from the profiler's rows of
    the kernels (and memsets) that ``fn`` itself launches: ``parts`` maps a
    part's name to substrings of its kernels' names; what matches none is
    ``other_ms``. A trace in which a part of ``need`` (default: every
    part) has no device row (the profiler lost rows of its device
    buffers) is taken again with a wider window, one try for each entry
    of PARTS_PAD_S; the callers' checks on the parts then apply to the
    last trace taken."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    need = set(parts if need is None else need)
    fn()
    torch.cuda.synchronize()
    for i, pad in enumerate(PARTS_PAD_S):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        rows = device_rows(prof)
        seen = {name for e in rows for name, keys in parts.items()
                if any(k in e.name for k in keys)}
        if seen >= need:
            break
        print(f"parts_ms: trace {i + 1} of {len(PARTS_PAD_S)} (pad {pad} s) "
              f"lacks device rows of {sorted(need - seen)}; "
              f"{len(rows)} device rows", file=sys.stderr, flush=True)
    out = {name: 0.0 for name in (*parts, "other_ms")}
    for e in rows:
        part = next((name for name, keys in parts.items()
                     if any(k in e.name for k in keys)), "other_ms")
        out[part] += e.device_time_total / 1e3 / reps
    return out


# the kernels of first_k and of the scatter by part (names as the profiler
# prints them)
FIRST_K_PARTS = {"count_ms": ("first_k_count_kernel",),
                 "write_ms": ("first_k_write_kernel",)}
SCATTER_PARTS = {"prep_sort_ms": ("scatter_keys_kernel", "RadixSort"),
                 "sum_ms": ("segsum_tile_kernel", "segsum_carry_kernel",
                            "Memset")}


def bound_ms(n_bytes: float, n_ops: float = 0.0):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stage_cfg(sc: dict, stage: str):
    """(config, raster options) of ``stage`` on the scene."""
    return sc["seq_cfg" if stage == "seq" else "cfg"], sc["raster_opts"]


SMALL_PHASE = {"init": "small", "split": "small_split", "seq": "small_seq"}


def small_scenes(seed_steps: int):
    """The tiny scene with its seq template on the CPU and on the card,
    holding the same parameters."""
    cpu = build_scene("tiny", "cpu", seed_steps)
    gpu = build_scene("tiny", "cuda", 0)
    gpu["params"] = tree_map(lambda t: t.to("cuda"), cpu["params"])
    for sc in (cpu, gpu):
        add_seq(sc, "tiny")
    return cpu, gpu


def compare_small_tick(cpu: dict, gpu: dict, stage: str) -> None:
    """One tick of ``stage``, kernels on the card vs plain versions on the
    CPU, with the same random draws: counters exact, rel 1e-3."""
    from d3human_tpu_torch.train.step import stage_tick

    phase = SMALL_PHASE[stage]
    draws = tick_draws(stage_cfg(cpu, stage)[0], stage, seed=1)
    out = {}
    for name, sc in (("cpu", cpu), ("cuda", gpu)):
        cfg, raster_opts = stage_cfg(sc, stage)
        out[name] = scalars(stage_tick(
            stage, sc["model"], sc["tex"], sc["perceptual"],
            sc["perc_params"], sc["params"], sc["target"], 7, cfg,
            raster_opts, draws=draws, template=sc.get("seq_template")))
    check(set(out["cpu"]) == set(out["cuda"]), f"{phase}: keys differ")
    worst = 0.0
    for k, want in out["cpu"].items():
        got = out["cuda"][k]
        if k.endswith(EXACT):
            check(got == want, f"{phase}: {k} {got} != {want}")
        else:
            err = abs(got - want) / max(abs(want), 1e-3)
            worst = max(worst, err)
            check(err <= 1e-3, f"{phase}: {k} {got} vs {want}")
    for k in {"init": ("n_cross",), "seq": ("cap_cov",),
              "split": ("cloth_n_cross", "body_n_cross")}[stage]:
        check(out["cpu"][k] > 0, f"{phase}: empty mesh ({k})")
    emit(phase, ok=True, tolerance="counters exact, rel 1e-3",
         worst_rel_err=worst, cuda=out["cuda"])


def phase_small(seed_steps: int) -> None:
    """The whole init, split and seq ticks and the pbr render, kernels on
    the card vs plain versions on the CPU, on one tiny scene with
    identical parameters and random draws; the bfloat16 SDF MLP."""
    cpu, gpu = small_scenes(seed_steps)
    for stage in SMALL_PHASE:
        compare_small_tick(cpu, gpu, stage)
    phase_small_pbr(cpu, gpu)
    phase_small_bf16(BF16_POINTS, "cuda")


BF16_POINTS = 16384      # points of the small_bf16 check
# rel-L2 of the bf16 MLP, card against CPU: 2^-9, half a bf16 ulp (the
# other accumulation order rounds some hidden values to the next bf16)
BF16_TOL = 2.0 ** -9


def phase_small_bf16(n: int, device: str) -> dict:
    """The SDF MLP at the field config's width (``field.use_bfloat16``:
    bf16 products, float32 accumulation) on ``n`` seeded points on
    ``device`` against the CPU: output, point gradient and a hidden
    layer's weight gradient within BF16_TOL rel-L2 (a hidden value whose
    float32 sum lies at a bf16 rounding tie may round the other way on
    another accumulation order, which moves it by 2^-8 of itself), and at
    least half the CPU's bf16-to-float32 distance from the float32 MLP;
    ms of a forward + backward in bf16 and in float32 (CUDA events)."""
    import torch

    from d3human_tpu_torch.config import FieldConfig
    from d3human_tpu_torch.models.fields import MLP

    f = FieldConfig()
    gen = torch.Generator().manual_seed(3)
    nets = {bf: MLP(n_freq=f.n_freq, d_hidden=f.d_hidden,
                    n_hidden=f.n_hidden, skip_in=f.skip_in, d_out=1,
                    use_bfloat16=bf) for bf in (True, False)}
    params = nets[True].init(gen, "cpu")
    pts = torch.rand((n, 3), generator=gen) * 1.6 - 0.8

    def prepared(dev, bf):
        """fn() -> (output, point gradient, hidden weight gradient)."""
        p = tree_map(lambda t: t.to(dev).requires_grad_(True), params)
        x = pts.to(dev).requires_grad_(True)

        def fn():
            x.grad = p["layers"][2]["w"].grad = None
            y = nets[bf].apply(p, x)
            (y * y).sum().backward()
            return y.detach(), x.grad, p["layers"][2]["w"].grad
        return fn

    got, want, f32 = (prepared(*a)() for a in ((device, True), ("cpu", True),
                                               ("cpu", False)))
    names = ("output", "point_grad", "hidden_w_grad")
    err = {k: rel_l2(a, b) for k, a, b in zip(names, got, want)}
    gap = {k: rel_l2(a, b) for k, a, b in zip(names, want, f32)}
    off = {k: rel_l2(a, b) for k, a, b in zip(names, got, f32)}
    for k in names:
        # and the device's result is the bf16 one, not the float32 one
        check(err[k] <= BF16_TOL and off[k] >= 0.5 * gap[k],
              f"small_bf16: {k} rel-L2 {err[k]} to the CPU's bf16, "
              f"{off[k]} to its float32 ({gap[k]} between those)")
    out = dict(points=n, d_hidden=f.d_hidden, n_hidden=f.n_hidden,
               tolerance=BF16_TOL, rel_l2=err, bf16_vs_f32=gap,
               device_vs_f32=off)
    if device == "cuda":
        out["fwd_bwd_ms"] = {name: cuda_ms(prepared(device, bf))
                             for name, bf in (("bf16", True),
                                              ("f32", False))}
    emit("small_bf16", **out)
    return out


def check_first_k(what: str, mask, k: int) -> dict:
    """first_k at one shape: exactly equal to the plain version and to
    ``torch.nonzero`` + pad, its two launches the only kernels of its calls,
    and faster than the library; its times and bound."""
    import torch

    from d3human_tpu_torch.ops import compaction

    fk = compaction.first_k_indices
    n = mask.numel()
    counts0 = (fk.calls, fk.launches)
    got = fk(mask, k, n)
    check((fk.calls - counts0[0], fk.launches - counts0[1])
          == (1, compaction.LAUNCHES),
          f"first_k {what}: {fk.launches - counts0[1]} launches counted "
          f"for one call")
    want = compaction.first_k_plain(mask, k, n)
    check(torch.equal(got, want), f"first_k {what}: kernel != plain")

    def library():
        nz = torch.nonzero(mask.reshape(-1)).reshape(-1)[:k].int()
        return torch.cat([nz, torch.full((k - nz.numel(),), n,
                                         dtype=torch.int32,
                                         device=mask.device)])

    check(torch.equal(library(), want), f"first_k {what}: yardstick")
    # only the count and write launches run in the wrapper's calls
    parts = parts_ms(lambda: fk(mask, k, n), FIRST_K_PARTS)
    check(parts["count_ms"] > 0 and parts["write_ms"] > 0
          and parts["other_ms"] == 0,
          f"first_k {what}: the profiler's kernel rows {parts}")
    b, by = bound_ms(n * 1 + k * 4)
    # the wrapper's and the library's eager times in turns, each the least
    # of three means of 10 calls: both are host-bound at these sizes, and
    # one stall of the host inside one mean does not decide the comparison
    trials = [(cuda_ms(lambda: fk(mask, k, n)), cuda_ms(library))
              for _ in range(3)]
    ms, library_ms = (min(t) for t in zip(*trials))
    check(ms < library_ms, f"first_k {what}: slower than torch.nonzero + "
          f"pad (ms, library ms of three trials: {trials})")
    return dict(
        call=what, n=n, k=k, set=int(mask.sum()), bound_ms=b, bound_by=by,
        launches_per_call=compaction.LAUNCHES, max_abs_err=0.0, ms=ms,
        device_ms=graph_ms(lambda: fk(mask, k, n)),
        # 20 calls a replay: one call's device time after another's
        device_ms_back_to_back=graph_ms(lambda: fk(mask, k, n), calls=20),
        **parts,
        plain_ms=cuda_ms(lambda: compaction.first_k_plain(mask, k, n)),
        library_ms=library_ms)


SCAN_TOL = 1e-6          # the scan against torch.cumsum, of the total


def check_scan(what: str, x) -> dict:
    """The fixed-order scan at one shape: within SCAN_TOL of the largest
    prefix against ``torch.cumsum`` (its plain version, and the library
    call), bit for bit across two calls, two launches a call; its times
    and bound (each entry read once and written once, one addition
    each)."""
    import torch

    from d3human_tpu_torch.ops import scan

    fn = scan.inclusive_scan
    counts0 = (fn.calls, fn.launches)
    got = fn(x)
    check((fn.calls - counts0[0], fn.launches - counts0[1])
          == (1, scan.LAUNCHES),
          f"scan {what}: {fn.launches - counts0[1]} launches counted for "
          "one call")
    want = scan.inclusive_scan_plain(x)
    err = float((got - want).abs().max())
    scale = float(want.abs().max().clamp_min(1e-30))
    check(err <= SCAN_TOL * scale, f"scan {what}: {err} from torch.cumsum "
          f"(largest prefix {scale})")
    check(torch.equal(fn(x), got), f"scan {what}: two calls differ")
    n = x.numel()
    b, by = bound_ms(8 * n, n)
    return dict(call=what, shape=tuple(x.shape), n=n, bound_ms=b,
                bound_by=by, launches_per_call=scan.LAUNCHES,
                max_abs_err=err, rel_err=err / scale, bitwise_repeat=True,
                ms=cuda_ms(lambda: fn(x)), device_ms=graph_ms(lambda: fn(x)),
                plain_ms=cuda_ms(lambda: scan.inclusive_scan_plain(x)),
                library_ms=cuda_ms(lambda: torch.cumsum(x, -1)))


SOFTPLUS_TOL = 1e-6      # the backward against its plain version, of the
                         # largest entry


def check_bias_softplus(what: str, n: int, c: int, t: int) -> dict:
    """The fused bias + softplus of the fields MLP at one layer's shape,
    product z [n, c] and tail [n, t], on seeded values: the forward equal
    to the plain composition bit for bit, g_z and g_b within SOFTPLUS_TOL
    of the plain backward, g_b the same bits on a second call, one launch
    forward and two backward; device ms of each (CUDA-graph replays), the
    bound (the forward reads z and the tail and writes [h, tail]; the
    backward reads g_h and h and writes g_z: bytes at 3.35 TB/s), the plain
    versions' ms and ``library_ms``: the composition it replaced,
    ``softplus(100 (z + b)) * 0.01`` and ``torch.cat`` forward, and its
    autograd backward to z, b and the tail."""
    import torch
    import torch.nn.functional as F

    from d3human_tpu_torch.ops import bias_softplus as bs

    gen = torch.Generator(device="cuda").manual_seed(n + t)
    z = torch.randn((n, c), generator=gen, device="cuda") * 0.3
    b = torch.randn((c,), generator=gen, device="cuda") * 0.1
    tail = torch.randn((n, t), generator=gen, device="cuda") if t else None
    g_out = torch.randn((n, c + t), generator=gen, device="cuda")
    fn = bs.bias_softplus100
    counts0 = (fn.launches, fn.calls)
    out = fn(z, b, tail)
    g_h, h = g_out[:, :c], out[:, :c]
    gz, gb = bs._backward_cuda(g_h, h)
    check((fn.launches - counts0[0], fn.calls - counts0[1])
          == (bs.LAUNCHES + bs.GRAD_LAUNCHES, 1),
          f"bias_softplus {what}: {fn.launches - counts0[0]} launches "
          "counted for one forward and one backward call")
    check(torch.equal(out, bs.bias_softplus100_plain(z, b, tail)),
          f"bias_softplus {what}: the forward differs from the plain one")
    want_z, want_b = bs.bias_softplus100_grad_plain(g_h, h)
    errs = {}
    for name, got, want in (("g_z", gz, want_z), ("g_b", gb, want_b)):
        errs[name] = float((got - want).abs().max() / want.abs().max())
        check(errs[name] <= SOFTPLUS_TOL, f"bias_softplus {what}: {name} "
              f"{errs[name]} from the plain backward")
    check(torch.equal(bs._backward_cuda(g_h, h)[1], gb),
          f"bias_softplus {what}: two backward calls give other g_b bits")

    leaves = [x.clone().requires_grad_(True)
              for x in (z, b) + (() if tail is None else (tail,))]

    def composition():
        y = F.softplus(100.0 * (leaves[0] + leaves[1])) * 0.01
        if tail is not None:
            y = torch.cat([y, leaves[2]], dim=-1)
        return torch.autograd.grad(y, leaves, g_out)

    def plain():
        o = bs.bias_softplus100_plain(z, b, tail)
        return bs.bias_softplus100_grad_plain(g_h, o[:, :c])

    fwd_b, fwd_by = bound_ms(4 * n * (2 * c + 2 * t) + 4 * c)
    bwd_b, bwd_by = bound_ms(4 * n * 3 * c + 4 * c)
    res = dict(call=what, n=n, c=c, t=t, bitwise_forward=True,
               rel_err=errs, bitwise_repeat=True,
               launches_per_call=dict(forward=bs.LAUNCHES,
                                      backward=bs.GRAD_LAUNCHES),
               bound_ms=fwd_b + bwd_b, bound_by=fwd_by,
               forward_bound_ms=fwd_b, backward_bound_ms=bwd_b,
               forward_device_ms=graph_ms(lambda: fn(z, b, tail)),
               backward_device_ms=graph_ms(
                   lambda: bs._backward_cuda(g_h, h)),
               ms=cuda_ms(lambda: bs._backward_cuda(
                   g_h, fn(z, b, tail)[:, :c])),
               plain_ms=cuda_ms(plain), library_ms=cuda_ms(composition))
    res["device_ms"] = res["forward_device_ms"] + res["backward_device_ms"]
    res["max_abs_err"] = max(float((gz - want_z).abs().max()),
                             float((gb - want_b).abs().max()))
    return res


LS_TOL = 1e-5           # linear_softplus against its plain version, of the
                        # largest entry (an f32 sum in another order)


def check_linear_softplus(what: str, n: int, k: int, c: int, t: int = 0,
                          dx: bool = False, w_rows: int = 0,
                          packed: bool = False) -> dict:
    """One fields-MLP layer of ``ops/linear_softplus.py`` on seeded values:
    the forward ``[softplus(100 (x @ w + b)) / 100, tail]`` of x [n, k]
    (a view of rows padded to 4 floats, as a hidden or skip layer's input;
    ``packed``: rows of k, as the MLP's first input), or
    with ``dx`` the input gradient ``(g @ w^T)[:, :c] * -expm1(-100 h)`` of
    g [n, k] through w [c', k] (c' = ``w_rows`` or c: 295 for the skip
    layer above h; h the first c columns of rows padded to 4 floats) with
    its bias column sums; within LS_TOL of the plain version, the same
    bits on a second call, its launches as the wrapper states them. Device
    ms (CUDA-graph replays), the bound (f32 operations at 67 TFLOP/s, or
    the bytes), the plain version's ms and ``library_ms``: what it
    replaces, the cuBLAS product and ``ops/bias_softplus.py``'s pass."""
    import torch

    from d3human_tpu_torch.ops import bias_softplus as bs
    from d3human_tpu_torch.ops import linear_softplus as ls

    gen = torch.Generator(device="cuda").manual_seed(n + k + c + t + dx)
    fn = ls.linear_softplus100
    before = fn.launches
    if not dx:
        x = torch.randn((n, k if packed else -(-k // 4) * 4), generator=gen,
                        device="cuda")[:, :k] * (1.0 / k ** 0.5)
        w = torch.randn((k, c), generator=gen, device="cuda") * 0.5
        b = torch.randn((c,), generator=gen, device="cuda") * 0.1
        tail = torch.randn((n, t), generator=gen, device="cuda") if t else \
            None
        got = (fn(x, w, b, tail),)
        call = lambda: fn(x, w, b, tail)  # noqa: E731
        plain = lambda: ls.linear_softplus100_plain(x, w, b, tail)  # noqa
        library = lambda: bs.bias_softplus100(x @ w, b, tail)  # noqa: E731
        launches, flops = ls.LAUNCHES, 2.0 * n * k * c
        n_bytes = 4 * (n * k + n * (c + t) + n * t + k * c)
    else:
        rows = w_rows or c
        g = torch.randn((n, k), generator=gen, device="cuda")
        w = torch.randn((rows, k), generator=gen, device="cuda") * 0.1
        h = torch.rand((n, -(-rows // 4) * 4), generator=gen,
                       device="cuda")[:, :c] * 0.05
        got = ls.linear_softplus100_dx(g, w, h)
        call = lambda: ls.linear_softplus100_dx(g, w, h)  # noqa: E731
        plain = lambda: ls.linear_softplus100_dx_plain(g, w, h)  # noqa
        library = lambda: bs._backward_cuda(  # noqa: E731
            (g @ w.t())[:, :c], h)
        launches, flops = ls.GRAD_LAUNCHES, 2.0 * n * k * c
        n_bytes = 4 * (n * k + 2 * n * c + k * c)
    check(fn.launches - before == launches,
          f"linear_softplus {what}: {fn.launches - before} launches for one "
          f"call, the wrapper states {launches}")
    want = plain()
    want = want if isinstance(want, tuple) else (want,)
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(got, want)]
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    check(max(errs) <= LS_TOL, f"linear_softplus {what}: {errs} from the "
          "plain version")
    again = call()
    again = again if isinstance(again, tuple) else (again,)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"linear_softplus {what}: two calls give other bits")
    bound, by = bound_ms(n_bytes, flops)
    res = dict(call=what, n=n, k=k, c=c, t=t, x_row=x.stride(0) if not dx
               else None, rel_err=errs,
               bitwise_plain=bitwise, bitwise_repeat=True,
               launches_per_call=launches, bound_ms=bound, bound_by=by,
               device_ms=graph_ms(call), ms=cuda_ms(call),
               plain_ms=cuda_ms(plain), library_ms=cuda_ms(library),
               max_abs_err=max(float((a - b).abs().max())
                               for a, b in zip(got, want)))
    res["share_of_bound"] = res["bound_ms"] / res["device_ms"]
    return res


def check_scatter(what: str, idx, live, C: int, rows_out: int, srt: bool,
                  gen, faster: bool = True) -> dict:
    """The scatter at one shape on random rows (zero where ``live`` is
    false): deterministic, within rel 1e-5 / abs 1e-6 of the plain version
    and within rel 1e-4 / abs 1e-4 of the float64 sum, two launches a
    call, and with ``faster`` faster than ``index_add_``; its times, parts
    and bound. ``index_add_``'s own distance to the float64 sum is
    reported: its atomics add a hot row's millions of terms in another
    order."""
    import torch

    from d3human_tpu_torch.ops import scatter

    dev = idx.device
    N = idx.numel()
    vals = torch.randn((N, C), generator=gen, device=dev) * live[:, None]
    calls0 = scatter.coo_scatter_add.calls
    launches0 = scatter.coo_scatter_add.launches
    got = scatter.coo_scatter_add(idx, vals, rows_out, sorted_idx=srt)
    per_call = scatter.coo_scatter_add.launches - launches0
    check(scatter.coo_scatter_add.calls - calls0 == 1
          and per_call == scatter._launches(N) == (2 if N > scatter.TILE
                                                   else 1),
          f"scatter {what}: {per_call} launches counted for one call")
    again = scatter.coo_scatter_add(idx, vals, rows_out, sorted_idx=srt)
    want = scatter.coo_scatter_add_plain(idx, vals, rows_out, srt)
    check(torch.equal(got, again), f"scatter {what}: not deterministic")
    # the plain version repeats the kernels' order of additions, so the
    # two should agree bit for bit (reported); what is required is the
    # tolerance of float32 sums taken in another order
    err = (got - want).abs()
    check(bool((err <= 1e-6 + 1e-5 * want.abs()).all()),
          f"scatter {what}: max err {float(err.max())}")
    keep = (idx >= 0) & (idx < rows_out)
    didx = torch.where(keep, idx, rows_out).long()

    def library():
        return torch.zeros((rows_out + 1, C), device=dev).index_add_(
            0, didx, vals)[:rows_out]

    def row_sum(v):
        return torch.zeros((rows_out + 1, C), dtype=v.dtype,
                           device=dev).index_add_(0, didx, v)[:rows_out]

    exact = row_sum(vals.double())
    k = torch.bincount(didx, minlength=rows_out + 1)[:rows_out]
    e_kernel = (got.double() - exact).abs()
    check(bool((e_kernel <= 1e-4 + 1e-4 * exact.abs()).all()),
          f"scatter {what}: {float(e_kernel.max())} from the float64 sum")
    e_library = (library().double() - exact).abs()
    # the parts, on the wrapper's own calls; a sorted call has no key
    # preparation and no sort
    parts = parts_ms(lambda: scatter.coo_scatter_add(
        idx, vals, rows_out, sorted_idx=srt), SCATTER_PARTS,
        need=("sum_ms",) if srt else None)
    check(parts["sum_ms"] > 0 and (parts["prep_sort_ms"] > 0) != srt,
          f"scatter {what}: the profiler's kernel rows {parts}")
    b, by = bound_ms(N * 4 * (1 + C) + rows_out * 4 * C)
    out = dict(
        call=what, N=N, C=C, out_rows=rows_out, sorted=srt,
        bound_ms=b, bound_by=by, launches_per_call=per_call,
        max_abs_err=float(err.max()), bitwise=torch.equal(got, want),
        kernel_vs_float64=float(e_kernel.max()),
        library_vs_float64=float(e_library.max()),
        max_rows_per_out_row=int(k.max()),
        ms=cuda_ms(lambda: scatter.coo_scatter_add(idx, vals, rows_out,
                                                   sorted_idx=srt)),
        # device time alone (CUDA graph replays)
        device_ms=graph_ms(lambda: scatter.coo_scatter_add(
            idx, vals, rows_out, sorted_idx=srt)),
        prep_sort_ms=parts["prep_sort_ms"], sum_ms=parts["sum_ms"],
        other_ms=parts["other_ms"],
        # yardstick for the sort part: the plain version's where, int32
        # keys, torch.sort and int64 permutation cast to int32
        prep_sort_plain_ms=graph_ms(lambda: scatter.sort_rows_plain(
            idx, rows_out, srt)),
        library_device_ms=graph_ms(library),
        # one call: the plain version ran just above (warm) and takes
        # 0.07-0.8 s at these shapes
        plain_ms=cuda_ms(lambda: scatter.coo_scatter_add_plain(
            idx, vals, rows_out, srt), reps=1, warm=0),
        library_ms=cuda_ms(library))
    check(not faster or out["ms"] < out["library_ms"],
          f"scatter {what}: slower than index_add_")
    return out


def binning_stats(binned, v_clip, faces, fvalid, res) -> dict:
    """The binning's time and how its tiles' lists fill."""
    from d3human_tpu_torch.ops import raster_resolve as rr
    from d3human_tpu_torch.ops.rasterizer import bin_faces

    lens = (binned.starts[1:] - binned.starts[:-1]).long()
    nb = int(binned.n_big)
    return dict(
        bin_faces_ms=cuda_ms(lambda: bin_faces(v_clip, faces, fvalid, res)),
        longest_list=int(lens.max()), n_global=nb,
        tiles_with_faces=int((lens > 0).sum()),
        tiles_over_128_slots=int((lens > 128).sum()),
        tiles_past_the_old_cut=int((lens > 896).sum()),
        chunks=int((-(-lens // rr.CHUNK)).sum())
        + binned.grid[2] * -(-nb // rr.CHUNK))


def check_resolve(binned, floor=None):
    """The tile resolve on one binning: the kernel's keys exactly equal to
    its plain version's and to its own on a second call, and the (slot,
    tile) pairs it counts on the device equal to the plain version's.
    Returns (the keys, a report with times and the bound: 18 f32
    operations per pair and pixel, 19 with a floor, at the card's f32
    rate, or the rows' bytes if more)."""
    import torch

    from d3human_tpu_torch.ops import raster_resolve as rr

    tile = (8, 128)
    _, ntx, NT = binned.grid
    Ppix = tile[0] * tile[1]
    args = (binned.rows, binned.faces, binned.starts, binned.big_base,
            binned.n_big, tile, ntx)
    dev = binned.rows.device

    def pairs_of(fn):
        rr.reset_pairs()
        out = fn()
        return out, int(rr.walked_pairs(dev))

    want, pairs_plain = pairs_of(
        lambda: rr.resolve_tiles_plain(*args, floor=floor))
    # one call, as the scatter's: the plain version ran just above
    plain_ms = cuda_ms(lambda: rr.resolve_tiles_plain(*args, floor=floor),
                       reps=1, warm=0)
    main = lambda: rr.resolve_tiles(*args, floor=floor)  # noqa: E731
    got, pairs = pairs_of(main)
    check(torch.equal(got, want), f"resolve: kernel != plain version "
          f"({int((got != want).sum())} keys differ)")
    check(torch.equal(main(), got), "resolve: a second call differs")
    check(pairs == pairs_plain, f"resolve: {pairs} pairs counted, the plain "
          f"version walked {pairs_plain}")
    check(bool((got != rr.MISS_KEY).any()), "resolve: no pixel covered")
    device_ms = graph_ms(main)
    peel = floor is not None
    lens = binned.starts[1:] - binned.starts[:-1]
    b, by = bound_ms(pairs * 64 + (2 if peel else 1) * NT * Ppix * 8,
                     (19.0 if peel else 18.0) * pairs * Ppix)
    return got, dict(NT=NT, longest_list=int(lens.max()),
                     n_global=int(binned.n_big), live_slots=pairs,
                     hit_pixels=int((got != rr.MISS_KEY).sum()),
                     chunk=rr.CHUNK, ctas_per_tile=rr.NY, pix=rr.PIX,
                     ms=cuda_ms(main), device_ms=device_ms,
                     plain_ms=plain_ms, bound_ms=b, bound_by=by,
                     bound_share=b / device_ms, max_abs_err=0.0)


def seq_kernel_inputs(sc: dict) -> dict:
    """The seq step's kernel inputs on the scene's template: the posed
    template, its binning and rasterization at the training resolution."""
    import torch

    from d3human_tpu_torch.ops.rasterizer import (
        bin_faces, rasterize, xfm_points,
    )

    cfg, t = sc["seq_cfg"], sc["seq_template"]
    res = tuple(cfg.render.train_res)
    p = sc["params"]
    with torch.no_grad():
        posed, _ = sc["model"].seq_deformed(p["geometry"], t, p["pose"], 0)
        v_clip = xfm_points(posed, sc["target"]["mvp"])
        fvalid = torch.ones((t.f.shape[0],), dtype=torch.bool,
                            device=posed.device)
        rast = rasterize(v_clip, t.f, fvalid, res)
        binned = bin_faces(v_clip, t.f, fvalid, res)
    return dict(posed=posed, v_clip=v_clip, fvalid=fvalid, rast=rast,
                binned=binned, res=res,
                P=int(res[0] * res[1] * cfg.render.max_covered_frac))


def kernel_summary(r: dict) -> dict:
    """A kernel line's numbers at one shape."""
    return {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "device_ms", "max_abs_err")
            if k in r}


def phase_kernels(sc: dict) -> list:
    """Each kernel vs its plain version on the full scene's inputs, at the
    init and split steps' shapes, then at the seq step's."""
    import torch

    from d3human_tpu_torch.ops import compaction, scatter
    from d3human_tpu_torch.ops import marching_tets as mt
    from d3human_tpu_torch.ops import raster_resolve as rr
    from d3human_tpu_torch.ops.rasterizer import (
        aa_pair_candidates, bin_faces, compact_cover, rasterize, xfm_points,
    )

    cfg, model = sc["cfg"], sc["model"]
    g, pose = sc["params"]["geometry"], sc["params"]["pose"]
    res = tuple(cfg.render.train_res)
    npix = res[0] * res[1]
    P = int(npix * cfg.render.max_covered_frac)
    with torch.no_grad():
        meshes = model.get_meshes(g, pose, 0)
        occ3 = (meshes.sdf > 0).reshape(model.grid.vert_dims)
        v_clip = xfm_points(meshes.verts_posed, sc["target"]["mvp"])
        faces, fvalid = meshes.mesh.faces, meshes.mesh.face_valid
        rast = rasterize(v_clip, faces, fvalid, res)
        binned = bin_faces(v_clip, faces, fvalid, res)
        pix_idx, pix_valid, fid = compact_cover(rast, P)
    seq = seq_kernel_inputs(sc)
    aa_k = 16 * max(res)
    rows = []

    # ---- first_k: exact against the plain version at all five shapes
    fk_times = [check_first_k(what, mask, k) for what, mask, k in [
        ("crossing edges", mt._structured_crossing(occ3),
         cfg.geometry.max_verts),
        ("valid tets", mt._structured_valid_tets(occ3),
         cfg.geometry.max_tets),
        ("covered pixels", (rast.tri_id > 0).reshape(-1), P),
        ("aa pairs x", aa_pair_candidates(rast, 1, 0.01).reshape(-1), aa_k),
        ("aa pairs y", aa_pair_candidates(rast, 0, 0.01).reshape(-1), aa_k),
    ]]
    fk_seq = check_first_k("seq covered pixels",
                           (seq["rast"].tri_id > 0).reshape(-1), seq["P"])
    emit("kernel_first_k", exact=True, tile_bytes=compaction.TILE_BYTES,
         calls=fk_times + [fk_seq])
    big = fk_times[0]
    rows.append(dict(name="first_k_indices", route="cuda",
                     source="d3human_tpu_torch/csrc/first_k.cu",
                     replaces="d3human_tpu/ops/compaction.py:37",
                     shape=f"n={big['n']} k={big['k']}", max_abs_err=0.0,
                     ms=big["ms"], plain_ms=big["plain_ms"],
                     bound_ms=big["bound_ms"], bound_by=big["bound_by"],
                     library_ms=big["library_ms"],
                     device_ms=big["device_ms"],
                     device_ms_back_to_back=big["device_ms_back_to_back"],
                     count_ms=big["count_ms"], write_ms=big["write_ms"],
                     seq=dict(kernel_summary(fk_seq), shape=(
                         f"n={fk_seq['n']} k={fk_seq['k']}"))))

    # ---- scatter: vertex-gather backward, face-normal corner backward,
    # and the sorted image scatter, at their main-path shapes; then the seq
    # step's Laplacian (6F rows x 4) and face-normal backward (3F x 3).
    # Rows that carry a zero cotangent on the step (empty pixel slots, dead
    # faces) are zero here too.
    dev = meshes.verts_posed.device
    gen = torch.Generator(device=dev).manual_seed(0)
    V = meshes.verts_posed.shape[0]
    # the finest hash level's rows of the covered pixels' texture points
    # (here the template-space centroid of each pixel's face)
    tex = sc["tex"]
    enc, lvl = tex.encoder, tex.encoder.n_levels - 1
    pts = meshes.verts_template[faces[fid.long()].long()].mean(1)
    u = ((pts - tex.bbox_lo) / (tex.bbox_hi - tex.bbox_lo)).clamp(0.0, 1.0)
    hash_idx = enc._corner_index(
        lvl, torch.floor(u * enc.resolutions[lvl]).to(torch.int32))
    corners = faces[fid.long()].reshape(-1)
    sc_times = [check_scatter(*c, gen) for c in [
        ("vertex gather bwd", corners, pix_valid.repeat_interleave(3), 8, V,
         False),
        ("face-normal gather bwd", faces.reshape(-1),
         fvalid.repeat_interleave(3), 3, V, False),
        ("image scatter", pix_idx, pix_valid, 4, npix, True),
        ("vertex gather bwd, shaded (14-wide)", corners,
         pix_valid.repeat_interleave(3), 14, V, False),
        ("hash level bwd (corner-packed rows)", hash_idx, pix_valid,
         8 * enc.n_features, enc.level_sizes[lvl], False),
    ]]
    tf = sc["seq_template"].f
    Vs = sc["seq_template"].v.shape[0]
    lap_idx = tf[:, [0, 1, 1, 2, 2, 0]].T.reshape(-1)
    # with no hot row index_add_ beats the kernel at these shapes; they are
    # held to the library again once the sort of the static template's
    # indices is reused across calls (ROADMAP Queue 2 item 8)
    sc_seq = [check_scatter(*c, gen, faster=False) for c in [
        ("seq laplacian", lap_idx, torch.ones_like(lap_idx, dtype=torch.bool),
         4, Vs, False),
        ("seq face-normal gather bwd", tf.reshape(-1),
         torch.ones((tf.numel(),), dtype=torch.bool, device=dev), 3, Vs,
         False),
    ]]
    emit("kernel_scatter", deterministic=True, tolerance="rel 1e-5 abs 1e-6",
         tile=scatter.TILE, calls=sc_times + sc_seq)
    big = sc_times[0]
    rows.append(dict(name="coo_scatter_add", route="cuda",
                     source="d3human_tpu_torch/csrc/scatter.cu",
                     replaces="d3human_tpu/ops/scatter.py:41",
                     shape=f"N={big['N']} C={big['C']} out={big['out_rows']}",
                     max_abs_err=max(c["max_abs_err"] for c in sc_times),
                     ms=big["ms"], plain_ms=big["plain_ms"],
                     bound_ms=big["bound_ms"], bound_by=big["bound_by"],
                     library_ms=big["library_ms"],
                     device_ms=big["device_ms"],
                     prep_sort_ms=big["prep_sort_ms"], sum_ms=big["sum_ms"],
                     seq={c["call"]: dict(kernel_summary(c), shape=(
                         f"N={c['N']} C={c['C']} out={c['out_rows']}"))
                          for c in sc_seq}))

    # ---- the fixed-order scan: the eikonal sampling's area CDF of the
    # scene's extraction, and the light probe's column CDFs (256 rows)
    from d3human_tpu_torch.ops import mesh_ops, scan
    from d3human_tpu_torch.render.light import create_trainable_env

    with torch.no_grad():
        fn_raw = mesh_ops.face_normals(meshes.verts_posed, faces,
                                       normalize=False)
        area = torch.where(fvalid, 0.5 * torch.sqrt(torch.clamp_min(
            (fn_raw * fn_raw).sum(-1), 1e-20)), 0.0)
    probe = create_trainable_env(torch.Generator().manual_seed(4),
                                 cfg.render.probe_res, scale=1.0,
                                 device=dev)["base"].amax(-1)
    sn = [check_scan("eikonal area cdf", area),
          check_scan("light probe column cdfs", probe)]
    emit("kernel_scan", tolerance=f"{SCAN_TOL} of the largest prefix",
         tile=scan.TILE, calls=sn)
    rows.append(dict(name="inclusive_scan", route="cuda",
                     source="d3human_tpu_torch/csrc/scan.cu",
                     replaces="d3human_tpu/ops/mesh_ops.py:168 (jnp.cumsum;"
                              " port-only, no Pallas kernel)",
                     shape=f"n={sn[0]['n']}", max_abs_err=sn[0]["max_abs_err"],
                     ms=sn[0]["ms"], plain_ms=sn[0]["plain_ms"],
                     bound_ms=sn[0]["bound_ms"], bound_by=sn[0]["bound_by"],
                     library_ms=sn[0]["library_ms"],
                     device_ms=sn[0]["device_ms"],
                     probe=dict(kernel_summary(sn[1]), shape=(
                         f"{sn[1]['shape'][0]} rows x {sn[1]['shape'][1]}"))))

    # ---- the fields MLP's fused bias + softplus at the SDF fit's shapes:
    # a hidden layer at every grid vertex, and the layer before the skip,
    # which writes [h, encoding]
    from d3human_tpu_torch.ops import bias_softplus

    fc = cfg.field
    nv = model.grid.verts.shape[0]
    sp = [check_bias_softplus("hidden layer", nv, fc.d_hidden, 0),
          check_bias_softplus("before the skip", nv, fc.d_hidden,
                              model.sdf_mlp.d_emb)]
    emit("kernel_bias_softplus", bitwise_forward=True,
         tolerance=f"{SOFTPLUS_TOL} of the largest entry",
         rows_per_cta=bias_softplus.ROWS, calls=sp)
    rows.append(dict(name="bias_softplus100", route="cuda",
                     source="d3human_tpu_torch/csrc/softplus100.cu",
                     replaces="port-only (the JAX MLP's softplus is plain "
                              "jnp: d3human_tpu/models/fields.py)",
                     shape=f"N={nv} C={fc.d_hidden}",
                     **kernel_summary(sp[0]),
                     forward_device_ms=sp[0]["forward_device_ms"],
                     backward_device_ms=sp[0]["backward_device_ms"],
                     skip=dict(kernel_summary(sp[1]),
                               shape=f"N={nv} C={fc.d_hidden} + "
                                     f"{model.sdf_mlp.d_emb}")))

    # ---- the fields MLP's products with the bias + softplus in their
    # epilogue, forward and input gradient, at the SDF fit's shapes, then
    # at the nonrigid DeformMLP's: pretrain_nonrigid_zero at every grid
    # vertex, the seq step at the seq template's cloth and body vertices
    from d3human_tpu_torch.ops import linear_softplus

    emb = model.sdf_mlp.d_emb
    ls_fwd = [check_linear_softplus("input layer", nv, emb, fc.d_hidden,
                                    packed=True),
              check_linear_softplus("hidden layer", nv, fc.d_hidden,
                                    fc.d_hidden),
              check_linear_softplus("before the skip", nv, fc.d_hidden,
                                    fc.d_hidden, emb),
              check_linear_softplus("skip layer", nv, fc.d_hidden + emb,
                                    fc.d_hidden)]
    ls_dx = [check_linear_softplus("dx hidden layer", nv, fc.d_hidden,
                                   fc.d_hidden, dx=True),
             check_linear_softplus("dx skip layer", nv, fc.d_hidden,
                                   fc.d_hidden, dx=True,
                                   w_rows=fc.d_hidden + emb),
             check_linear_softplus("dx output layer", nv, 1, fc.d_hidden,
                                   dx=True)]
    nr, tmpl = model.nonrigid, sc["seq_template"]
    nr_k = nr.d_extra_in + nr.d_emb
    nr_at = [("grid", nv), ("seq cloth", int(tmpl.cloth_vidx.shape[0])),
             ("seq body", int(tmpl.body_vidx.shape[0]))]
    ls_fwd += [check_linear_softplus(f"nonrigid input layer, {at}", n, nr_k,
                                     nr.d_hidden, packed=True)
               for at, n in nr_at]
    ls_fwd += [check_linear_softplus("nonrigid before the skip, grid", nv,
                                     nr.d_hidden, nr.d_hidden, nr.d_emb),
               check_linear_softplus("nonrigid skip layer, grid", nv,
                                     nr.d_hidden + nr.d_emb, nr.d_hidden)]
    ls_dx += [check_linear_softplus(f"dx nonrigid output layer, {at}", n,
                                    nr.d_out, nr.d_hidden, dx=True)
              for at, n in nr_at]
    ls_dx += [check_linear_softplus("dx nonrigid skip layer, grid", nv,
                                    nr.d_hidden, nr.d_hidden, dx=True,
                                    w_rows=nr.d_hidden + nr.d_emb)]
    emit("kernel_linear_softplus", tolerance=f"{LS_TOL} of the largest entry",
         tile_rows=linear_softplus.TILE_ROWS, forward=ls_fwd, dx=ls_dx)
    rows.append(dict(name="linear_softplus100", route="cuda",
                     source="d3human_tpu_torch/csrc/linear_softplus.cu",
                     replaces="port-only (the JAX MLP's products and "
                              "softplus are plain jnp: "
                              "d3human_tpu/models/fields.py)",
                     shape=f"N={nv} K={fc.d_hidden} C={fc.d_hidden}",
                     **kernel_summary(ls_fwd[1]),
                     dx=dict(kernel_summary(ls_dx[0]),
                             shape=f"N={nv} Kd={fc.d_hidden} "
                                   f"C={fc.d_hidden}"),
                     calls={r["call"]: kernel_summary(r)
                            for r in ls_fwd + ls_dx}))

    # ---- tile resolve on the scene's own binning: exact keys
    emit("bin_faces", **binning_stats(binned, v_clip, faces, fvalid, res))
    got, rs = check_resolve(binned)
    # the seq template's binning (392k faces at the seq bench's size)
    sb = seq["binned"]
    seq_bin = binning_stats(sb, seq["v_clip"], sc["seq_template"].f,
                            seq["fvalid"], seq["res"])
    _, rs_seq = check_resolve(sb)
    emit("kernel_resolve", exact=True, **rs,
         seq=dict(rs_seq, binning=seq_bin))
    rows.append(dict(name="resolve_tiles", route="cuda",
                     source="d3human_tpu_torch/csrc/raster_resolve.cu",
                     replaces="d3human_tpu/ops/pallas_raster.py:52",
                     shape=(f"NT={rs['NT']} longest={rs['longest_list']} "
                            f"pairs={rs['live_slots']} P={8 * 128}"),
                     **kernel_summary(rs), library_ms=None,
                     seq=dict(kernel_summary(rs_seq), library_ms=None,
                              shape=(f"NT={rs_seq['NT']} "
                                     f"longest={rs_seq['longest_list']} "
                                     f"live={rs_seq['live_slots']}"))))

    # ---- the depth-peel step on the same rows: layer 0's keys as the
    # floor; exact keys, every hit strictly behind its floor, and a pixel
    # that missed in layer 0 misses again
    floor = got
    got_p, ps = check_resolve(binned, floor=floor)
    hit_p = got_p != rr.MISS_KEY
    check(bool(hit_p.any()), "resolve with floor: no second layer")
    check(bool((got_p[hit_p] > floor[hit_p]).all()),
          "resolve with floor: a key at or below its floor")
    check(not bool(hit_p[floor == rr.MISS_KEY].any()),
          "resolve with floor: a hit behind a miss")
    emit("kernel_resolve_peel", exact=True, **ps)
    rows.append(dict(name="resolve_tiles_peel", route="cuda",
                     source="d3human_tpu_torch/csrc/raster_resolve.cu",
                     replaces="d3human_tpu/ops/pallas_raster.py:58",
                     shape=(f"NT={ps['NT']} longest={ps['longest_list']} "
                            f"pairs={ps['live_slots']} P={8 * 128} + floor"),
                     **kernel_summary(ps), library_ms=None))
    return rows


def reset_counts() -> None:
    """Zero every counter of the port's kernel registry."""
    from d3human_tpu_torch.ops import cuda_lib

    cuda_lib.reset_counts()


def read_counts() -> dict:
    """Kernel launches since ``reset_counts``, by the kernel table's names,
    and the wrappers' ``calls`` (``cuda_lib.read_counts``)."""
    from d3human_tpu_torch.ops import cuda_lib

    return cuda_lib.read_counts()


# calls per step the stage's code path must make (first_k: crossing edges
# and valid tets once, then per render covered pixels + AA pairs x, y; the
# resolve: one launch a call; the scan: the eikonal sampling's area CDF of
# each extraction)
STEP_CALLS = {"init": {"first_k_indices": 5, "resolve_tiles": 1,
                       "inclusive_scan": 1},
              "split": {"first_k_indices": 8, "resolve_tiles": 2,
                        "inclusive_scan": 2},
              "seq": {"first_k_indices": 3, "resolve_tiles": 1,
                      "inclusive_scan": 0}}


def stage_step_fn(sc: dict, stage: str):
    from d3human_tpu_torch.train.step import make_train_step

    cfg, raster_opts = stage_cfg(sc, stage)
    return make_train_step(stage, sc["model"], sc["tex"], sc["perceptual"],
                           sc["perc_params"], cfg, raster_opts,
                           template=sc.get("seq_template"))


def check_step_metrics(stage: str, m: dict, where: str) -> None:
    for k, v in m.items():
        check(math.isfinite(v), f"{where}: {k} = {v}")
    if stage == "seq":
        check(m["cap_cov"] > 0, f"{where}: n_cov == 0")
        check(m["delta_loss"] > 0, f"{where}: no nonrigid offset")
        return
    for half in (("",) if stage == "init" else ("cloth_", "body_")):
        check(m[half + "n_cross"] > 0, f"{where}: {half}n_cross == 0")
        check(m[half + "cap_cov"] > 0, f"{where}: {half}n_cov == 0")


def phase_step(sc: dict, stage: str, steps: int, phase: str = None) -> dict:
    """Warm-up step, then ``steps`` timed training steps of ``stage``,
    reported as ``phase`` (default: the stage's step phase)."""
    import torch

    phase, state_key = phase or STEP_PHASE[stage], STATE_KEY[stage]
    step_fn = stage_step_fn(sc, stage)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = sc[state_key]
    t0 = time.perf_counter()
    state, m = step_fn(state, sc["target"], gen)          # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    reset_counts()
    events[0].record()
    metrics = []
    for i in range(steps):
        state, m = step_fn(state, sc["target"], gen)
        events[i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    launches = read_counts()
    sc[state_key] = state
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    for i, mm in enumerate(metrics):
        check_step_metrics(stage, scalars(mm), f"{phase} {i}")
    last = scalars(metrics[-1])
    calls = launches.pop("calls")
    check_path_counts(phase, launches, calls, STEP_CALLS[stage], steps)
    out = dict(steps=steps, step_ms=step_ms,
               mean_ms=sum(step_ms) / steps, warmup_s=warm_s,
               launches_per_step={k: n / steps for k, n in launches.items()},
               calls_per_step={k: n / steps for k, n in calls.items()},
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               losses=last)
    emit(phase, **out)
    return dict(out, launches=launches, calls=calls)


def validation_render(sc: dict, sign: float, generator=None):
    """The validation render of one split half (cloth +1, body -1) as the
    stage loop makes it: extraction + ``render_mesh_full`` with
    ``VAL_LAYERS`` depth-peeled layers, forward only."""
    import torch

    from d3human_tpu_torch.train.losses import render_stage_mesh

    cfg = dataclasses.replace(sc["cfg"], render=dataclasses.replace(
        sc["cfg"].render, layers=VAL_LAYERS))
    p = sc["params"]
    with torch.no_grad():
        return render_stage_mesh(
            generator, sc["model"], p["geometry"], p["pose"], sc["tex"],
            p["material"], sc["target"], cfg, msdf_sign=sign,
            raster_opts=sc["raster_opts"], compact=False)


def check_validation(sc: dict, who: str, meshes, buf) -> dict:
    """A validation render's buffers and the layers it composited (the
    same rasterization made once more): finite images, each further layer
    on no more pixels (a closed surface's back covers its front's), only
    where the layer before hit, behind it and on another face. Returns the
    layers' pixel counts."""
    import torch

    from d3human_tpu_torch.ops.rasterizer import rasterize, xfm_points

    H, W = sc["cfg"].render.train_res
    with torch.no_grad():
        layers = rasterize(
            xfm_points(meshes.verts_posed, sc["target"]["mvp"]),
            meshes.mesh.faces, meshes.mesh.face_valid, (H, W),
            layers=VAL_LAYERS, **(sc["raster_opts"] or {}))
    check(tuple(buf.shaded.shape) == (H, W, 4), f"{who}: shaded shape")
    for name in ("shaded", "geometric_normal", "normal", "kd", "depth",
                 "msdf_image"):
        check(bool(torch.isfinite(getattr(buf, name)).all()),
              f"{who}: {name} not finite")
    check(torch.equal(layers[0].tri_id, buf.rast.tri_id),
          f"{who}: the render's nearest layer is not layer 0")
    hit = [lay.tri_id > 0 for lay in layers]
    n_hit = [int(h.sum()) for h in hit]
    for k in range(1, VAL_LAYERS):
        near, far = layers[k - 1], layers[k]
        check(0 < n_hit[k] <= n_hit[k - 1],
              f"{who}: layer {k} covers {n_hit[k]} pixels, layer {k - 1} "
              f"{n_hit[k - 1]}")
        check(not bool((hit[k] & ~hit[k - 1]).any()),
              f"{who}: layer {k} hits where layer {k - 1} missed")
        # keys grow strictly; the quantized depth they carry may tie
        check(bool((far.zbuf[hit[k]] >= near.zbuf[hit[k]]).all()),
              f"{who}: layer {k} in front of layer {k - 1}")
        check(bool((far.tri_id[hit[k]] != near.tri_id[hit[k]]).all()),
              f"{who}: layer {k} repeats a face of layer {k - 1}")
    return dict(layer_pixels=n_hit,
                alpha_mean=float(buf.shaded[..., 3].mean()))


def phase_validate(sc: dict) -> dict:
    """Both halves' validation renders: a first render with the checks,
    then one timed render each (CUDA events) with the launch counts reset
    just before and read just after."""
    import torch

    from d3human_tpu_torch.ops import compaction

    gen = torch.Generator(device="cuda").manual_seed(2)
    halves, total, total_calls = {}, {}, {}
    for name, sign in (("cloth", 1.0), ("body", -1.0)):
        info = check_validation(sc, f"validate {name}",
                                *validation_render(sc, sign, gen))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reset_counts()
        start.record()
        validation_render(sc, sign, gen)
        end.record()
        end.synchronize()
        n = read_counts()
        calls = n.pop("calls")
        check(n["resolve_tiles"] == 1
              and n["resolve_tiles_peel"] == VAL_LAYERS - 1,
              f"validate {name}: resolve launches {n}")
        check(calls["first_k_indices"] > 0 and n["first_k_indices"]
              == compaction.LAUNCHES * calls["first_k_indices"]
              and n["coo_scatter_add"] > 0 and calls["coo_scatter_add"] > 0,
              f"validate {name}: launches {n}, calls {calls}")
        halves[name] = dict(info, ms=start.elapsed_time(end), launches=n,
                            calls=calls)
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
            total_calls[k] = total_calls.get(k, 0) + calls[k]
    emit("validate", layers=VAL_LAYERS, halves=halves,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return dict(launches=total, calls=total_calls)


def device_rows(prof) -> list:
    """The profiler's rows of device work: its kernels, copies and
    memsets. A range of the program (``record_function``) also shows on
    the device's timeline, as a CUDA row that is a user annotation; that
    row is left out, as torch's own tables leave it out."""
    import torch

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


# the port's profiler ranges (utils/logging.py:span) and the Chrome trace's
# categories of a launch on the host and of device work
SPAN_PREFIX = "d3h."
# the seq step's ranges, each once a step
SEQ_RANGES = ("d3h.seq.deform", "d3h.smplx.skin_weights", "d3h.seq.collision",
              "d3h.seq.mesh_reg")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span_ms(events: list) -> dict:
    """Device ms of the work launched inside each of the port's ranges, from
    a Chrome trace's events: a kernel, copy or memset counts toward each
    ``d3h.*`` name one of whose ranges (on the host) holds the time of its
    launch, found by its correlation id, whatever thread launched it
    (autograd's device thread launches the backward while the caller waits
    inside its range). Work launched inside no such range counts toward
    none. ``{}`` when the trace has no ``d3h.*`` range."""
    import bisect

    ranges: dict = {}
    for e in events:
        if (e.get("cat") == "user_annotation" and e.get("ph") == "X"
                and e["name"].startswith(SPAN_PREFIX)):
            ranges.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    out = {name: 0.0 for name in ranges}
    for name, rs in ranges.items():
        # one name's ranges never overlap: each is searched on its own
        rs.sort()
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            t = launch.get(e.get("args", {}).get("correlation"))
            if t is None:
                continue
            i = bisect.bisect_right(rs, (t, float("inf"))) - 1
            if i >= 0 and rs[i][0] <= t <= rs[i][1]:
                out[name] += e["dur"] / 1e3
    return out


def phase_profile(what: str, run, mlp_layers: tuple,
                  ranges: tuple = ()) -> None:
    """``run()`` once more under torch.profiler (a training step, a fit or
    a validation render): device busy time against its wall time, the
    device ms launched inside each of the port's ranges (``span_ms``; each
    of ``ranges`` has to be there), the (query, reference) pairs of the
    nearest-neighbour searches (``ops/knn.py:pair_counts``), the operators
    with the most device time, the port's own kernels; the fields MLP's
    input and hidden layers on the fused path and on the other, checked
    against ``mlp_layers`` (fused, other)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from d3human_tpu_torch.ops import cuda_lib, knn

    torch.cuda.synchronize()
    paths0 = cuda_lib.path_counts()
    knn.reset_pair_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    knn_pairs = knn.pair_counts()
    # the fields MLP's input and hidden layers on each path
    paths = cuda_lib.path_counts()
    layers = {k: paths[f"mlp_{k}"] - paths0[f"mlp_{k}"]
              for k in ("fused", "fallback")}
    check((layers["fused"], layers["fallback"]) == mlp_layers,
          f"profile {what}: the fields MLP's layers {layers}, expected "
          f"{mlp_layers} (fused, fallback)")
    kernels = device_rows(prof)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        PROFILE_TRACE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as fh:
        spans = span_ms(json.load(fh)["traceEvents"])
    os.remove(path)
    check(all(r in spans for r in ranges),
          f"profile {what}: ranges {sorted(spans)}, expected {ranges}")
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    avg = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total,
                 reverse=True)

    def row(e):
        return dict(name=e.key[:80], self_device_ms=
                    e.self_device_time_total / 1e3, calls=e.count)

    # the accumulating index_put is the backward of plain row indexing:
    # its input shapes say which gathers of the step it serves
    by_shape = [e for e in prof.key_averages(group_by_input_shape=True)
                if e.key == "aten::_index_put_impl_"]
    emit("profile", of=what, wall_ms=wall_ms, device_busy_ms=busy_ms,
         idle_share=1.0 - busy_ms / wall_ms, device_kernels=len(kernels),
         spans_ms=spans, knn_pairs=knn_pairs, mlp_layers=layers,
         top=[row(e) for e in avg[:20]],
         index_put=[dict(shapes=str(e.input_shapes), calls=e.count,
                         device_ms=e.device_time_total / 1e3)
                    for e in sorted(by_shape, key=lambda e:
                                    -e.device_time_total)[:12]],
         port_kernels=[row(e) for e in avg if any(k in e.key for k in (
             "first_k_count_kernel", "first_k_write_kernel",
             "scatter_keys_kernel", "DeviceRadixSort",
             "segsum_tile_kernel", "segsum_carry_kernel",
             "resolve_tiles_kernel", "fill_keys_kernel", "bias_softplus_",
             "linear_softplus_"))])


def phase_seq_knn(sc: dict) -> None:
    """The seq step's two K=1 searches alone at its shapes (CUDA events):
    the collision's cloth vertices against the body face centres, and the
    skinning-weight transfer of the template against the canonical body;
    beside the bound of their distance arithmetic (8 f32 operations a
    pair)."""
    import torch

    from d3human_tpu_torch.ops.knn import knn1

    t, p = sc["seq_template"], sc["params"]
    with torch.no_grad():
        posed, _ = sc["model"].seq_deformed(p["geometry"], t, p["pose"], 0)
        body = posed[t.body_vidx.long()]
        tri = body[t.body_f.long().clamp(0, body.shape[0] - 1)]
        centres = (tri[:, 0] + tri[:, 1] + tri[:, 2]) * (1.0 / 3.0)
        cloth = posed[t.cloth_vidx.long()]
        canon = sc["model"].canon.vs_template[0]
    out = {}
    for what, q, r in (("collision", cloth, centres),
                       ("skin weights", posed, canon)):
        b, by = bound_ms(4 * 3 * (q.shape[0] + r.shape[0]) + 8 * q.shape[0],
                         8.0 * q.shape[0] * r.shape[0])
        out[what] = dict(queries=q.shape[0], refs=r.shape[0],
                         ms=cuda_ms(lambda q=q, r=r: knn1(q, r), reps=3,
                                    warm=1), bound_ms=b, bound_by=by)
    emit("seq_knn", **out)


# ------------------------------------------------- the rest of the render

PBR_SAMPLES = 8           # light samples a pixel (render_mesh's default)
PBR_RENDERS = 2           # timed pbr forward + backward renders
SDF_CHUNK = 131072        # points a call of the SDF MLP as the occluder
                          # (the JAX package's default geometry.sdf_chunk)
PBR_BUFFERS = ("shaded", "diffuse_light", "specular_light", "kd", "ks",
               "normal", "geometric_normal", "depth", "alpha")


def rel_l2(a, b) -> float:
    import torch

    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float(torch.linalg.norm(a - b)
                 / torch.linalg.norm(b).clamp_min(1e-30))


def pbr_inputs(sc: dict, seed: int):
    """(light, material) copies of the scene's that take gradients; the
    probe is scaled by a seeded field in [0.5, 1.5] (the scene's probe is
    constant, which would make every texel equally likely)."""
    import torch

    base = sc["params"]["light"]["base"]
    scale = torch.rand(tuple(base.shape),
                       generator=torch.Generator().manual_seed(seed)) + 0.5
    light = {"base": (base.detach() * scale.to(base.device))
             .requires_grad_(True)}
    mat = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                   sc["params"]["material"])
    return light, mat


def init_mesh(sc: dict):
    """(posed verts, template verts, faces, face_valid) of the scene's init
    extraction, without gradients."""
    import torch

    p = sc["params"]
    with torch.no_grad():
        m = sc["model"].get_meshes(p["geometry"], p["pose"], 0)
    return m.verts_posed, m.verts_template, m.mesh.faces, m.mesh.face_valid


def pbr_render(sc: dict, light, mat, generator=None, draws=None,
               sdf_fn=None, mesh=None):
    """``mesh`` (default: the scene's init mesh, extracted now) through
    ``render_mesh(bsdf="pbr")`` at the training resolution."""
    from d3human_tpu_torch.render.pipeline import render_mesh

    cfg, t = sc["cfg"], sc["target"]
    return render_mesh(
        generator, *(mesh or init_mesh(sc)), t["mvp"], t["campos"],
        tuple(cfg.render.train_res), sc["tex"], mat, t["background"],
        raster_opts=sc["raster_opts"],
        max_covered_frac=cfg.render.max_covered_frac, bsdf="pbr",
        light_params=light, n_light_samples=PBR_SAMPLES, sdf_fn=sdf_fn,
        draws=draws)


def pbr_loss(buf, wts):
    import torch

    return (torch.cat([buf.shaded, buf.diffuse_light, buf.specular_light],
                      -1) * wts).sum()


def pbr_draws(sc: dict, seed: int, device):
    """The render's texture and normal-tap normals and the light sampler's
    uniforms, made on the CPU from ``seed`` and placed on ``device``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    H, W = sc["cfg"].render.train_res
    max_cov = int(H * W * sc["cfg"].render.max_covered_frac)
    n_tex = torch.randn((-(-max_cov // 2), 3), generator=gen)
    n_uv = torch.randn((H, W, 2), generator=gen)
    light = [torch.rand((PBR_SAMPLES,), generator=gen) for _ in "yx"]
    return (n_tex.to(device), n_uv.to(device),
            tuple(u.to(device) for u in light))


def sphere_sdf(center, radius: float):
    """An analytic ball, positive inside."""
    return lambda p: radius - (p - center).norm(dim=-1)


def scene_sdf(sc: dict):
    """The scene's SDF MLP on points [..., 3] (positive inside), SDF_CHUNK
    points a call; the canonical field, queried at posed points."""
    import torch

    model, g = sc["model"], sc["params"]["geometry"]

    def fn(p):
        flat = p.reshape(-1, 3)
        return torch.cat([model.sdf_mlp.apply(g["sdf_net"], c)[..., 0]
                          for c in flat.split(SDF_CHUNK)]).reshape(
            p.shape[:-1])
    return fn


def grads(light, mat):
    """(the light's gradient, the material's gradients as one vector)."""
    import torch

    leaves = []
    tree_map(leaves.append, mat)
    return light["base"].grad, torch.cat([
        (t.grad if t.grad is not None else torch.zeros_like(t)).reshape(-1)
        for t in leaves])


def phase_small_pbr(cpu: dict, gpu: dict) -> None:
    """``render_mesh(bsdf="pbr")`` on the tiny scene's init mesh (extracted
    once, on the CPU), kernels on the card against plain versions on the
    CPU, with the same random draws: every buffer within abs 1e-5, the
    light's and the texture's gradients within rel-L2 1e-4; without and
    with an analytic ball as the occluder (the shadow must darken some
    pixel)."""
    import torch

    H, W = cpu["cfg"].render.train_res
    wts = torch.randn((H, W, 10), generator=torch.Generator().manual_seed(6))
    mesh = init_mesh(cpu)
    out, diffuse = {}, {}
    for shadow in (False, True):
        got = {}
        for name, sc in (("cpu", cpu), ("cuda", gpu)):
            dev = sc["params"]["light"]["base"].device
            light, mat = pbr_inputs(sc, seed=7)
            sdf = (sphere_sdf(torch.tensor([0.0, 0.3, 0.3], device=dev), 0.3)
                   if shadow else None)
            buf = pbr_render(sc, light, mat, draws=pbr_draws(sc, 8, dev),
                             sdf_fn=sdf, mesh=[t.to(dev) for t in mesh])
            pbr_loss(buf, wts.to(dev)).backward()
            got[name] = (buf, *grads(light, mat))
        (bc, lc, mc), (bg, lg, mg) = got["cpu"], got["cuda"]
        err = {k: float((getattr(bg, k).detach().cpu()
                         - getattr(bc, k).detach()).abs().max())
               for k in PBR_BUFFERS}
        g_err = dict(light=rel_l2(lg, lc), material=rel_l2(mg, mc))
        check(max(err.values()) <= 1e-5, f"small_pbr: buffers {err}")
        check(max(g_err.values()) <= 1e-4, f"small_pbr: gradients {g_err}")
        check(float(lc.abs().max()) > 0 and float(mc.abs().max()) > 0,
              "small_pbr: a zero gradient")
        diffuse[shadow] = bc.diffuse_light.detach()
        out["shadow" if shadow else "no_shadow"] = dict(
            max_abs_err=err, grad_rel_l2=g_err,
            covered=int((bc.rast.tri_id > 0).sum()))
    check(bool((diffuse[True] < diffuse[False] - 1e-6).any())
          and bool((diffuse[True] <= diffuse[False] + 1e-6).all()),
          "small_pbr: the occluder darkens no pixel, or lightens one")
    emit("small_pbr", ok=True, tolerance="buffers abs 1e-5, gradients "
         "rel-L2 1e-4", samples=PBR_SAMPLES, **out)


def phase_pbr(sc: dict, device: str) -> dict:
    """``render_mesh(bsdf="pbr")`` on the scene's init mesh at the training
    resolution with the scene's probe and material: a recorded warm-up,
    PBR_RENDERS timed forward + backward renders without an occluder
    (the extraction included; gradients of the light and the texture
    finite and non-zero), then forward renders without gradients of the
    canonical mesh (the scene's SDF is the canonical field), with and
    without that SDF as the occluder (its sign checked inside the body
    first), on the same draws: the shadow darkens pixels and lightens
    none. Seconds and peak memory of each. Returns the kernels'
    launches and calls from just before the timed renders to just after
    the shadowed one, and the warm-up's kernel inputs by call site."""
    import torch

    from d3human_tpu_torch.ops.rasterizer import (
        barycentrics, interpolate, xfm_points,
    )

    cuda = device == "cuda"
    H, W = sc["cfg"].render.train_res
    gen = torch.Generator(device=device).manual_seed(9)
    wts = torch.randn((H, W, 10), generator=gen, device=device)
    light, mat = pbr_inputs(sc, seed=10)

    def fwd_bwd():
        for t in [light["base"]] + [mat]:
            tree_map(lambda x: setattr(x, "grad", None), t)
        buf = pbr_render(sc, light, mat, generator=gen)
        pbr_loss(buf, wts).backward()
        return buf

    with recording_kernel_inputs() as inputs:
        buf, warm_s = timed(device, fwd_bwd)
    g_light, g_mat = grads(light, mat)
    for what, g in (("light", g_light), ("material", g_mat)):
        check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
              f"pbr: the {what}'s gradient is zero or not finite")
    check(float(buf.specular_light.detach().abs().max()) > 0,
          "pbr: no specular light")
    reset_peak(device)
    reset_counts()
    fb_s = [timed(device, fwd_bwd)[1] for _ in range(PBR_RENDERS)]
    fb_peak = peak_gib(device)
    sdf = scene_sdf(sc)
    # the field is the canonical one: the no-gradient renders show the
    # canonical (template) mesh, the field's own zero set, so that it
    # occludes what it describes
    _, canon, faces, fvalid = init_mesh(sc)
    mesh = (canon, canon, faces, fvalid)
    with torch.no_grad():
        inside = float(sdf(torch.zeros((1, 3), device=device))[0])
        check(inside > 0, f"pbr: the scene's SDF is {inside} at the body's "
              "centre (the occluder must be positive inside)")
        draws = pbr_draws(sc, 11, device)
        plain, fwd_s = timed(device, lambda: pbr_render(
            sc, light, mat, draws=draws, mesh=mesh))
        reset_peak(device)
        shadowed, shadow_s = timed(device, lambda: pbr_render(
            sc, light, mat, draws=draws, sdf_fn=sdf, mesh=mesh))
        shadow_peak = peak_gib(device)
    counts = read_counts()
    calls = counts.pop("calls")
    for k in ("first_k_indices", "coo_scatter_add", "resolve_tiles"):
        check(not cuda or counts[k] > 0, f"pbr: {k} never launched")
    d0, d1 = plain.diffuse_light, shadowed.diffuse_light
    check(bool((d1 <= d0 + 1e-6).all()), "pbr: the occluder lightens")
    darker = int((d1 < d0 - 1e-6).any(-1).sum())
    check(darker > 0, "pbr: the occluder darkens no pixel")
    cover = plain.alpha[..., 0] > 0
    # where the shadow rays start: the shading normal's side of the surface
    # (the extraction winds faces both ways, so its vertex normals can
    # point into the body)
    with torch.no_grad():
        v_clip = xfm_points(canon, sc["target"]["mvp"])
        bary, _ = barycentrics(v_clip, faces, plain.rast, (H, W))
        pos = interpolate(canon, bary, faces, plain.rast)
        start_inside = sdf(pos + plain.normal[..., :3] * 1e-3) > 0
    emit("pbr", resolution=[H, W], samples=PBR_SAMPLES,
         probe=list(light["base"].shape), covered=int(cover.sum()),
         warmup_s=warm_s, fwd_bwd_ms=[s * 1e3 for s in fb_s],
         fwd_bwd_peak_gib=fb_peak, fwd_ms=fwd_s * 1e3,
         shadowed_fwd_s=shadow_s, shadowed_peak_gib=shadow_peak,
         sdf_queries=H * W * PBR_SAMPLES * 16, sdf_at_centre=inside,
         shadowed_pixels=darker,
         ray_origins_inside=int(start_inside[cover].sum()),
         diffuse_mean=float(d0[cover].mean()),
         shadowed_diffuse_mean=float(d1[cover].mean()),
         specular_mean=float(plain.specular_light[cover].mean()),
         grad_norm=dict(light=float(g_light.norm()),
                        material=float(g_mat.norm())),
         launches=counts, calls=calls)
    return dict(launches=counts, calls=calls, inputs=inputs)


def mobilenet_scene(sc: dict, device: str) -> dict:
    """The scene with the MobileNetV2 perceptual backbone on its He-init
    weights (the repository holds no pretrained npz)."""
    from d3human_tpu_torch.models.mobilenet import MobileNetFeatures

    mob = MobileNetFeatures()
    return dict(sc, perceptual=mob, perc_params=mob.init(None, device))


def mobilenet_features_err(msc: dict, device: str) -> list:
    """The taps' rel-L2 distance, on ``device`` against the CPU, of two
    seeded images at the perceptual crop."""
    import torch

    crop = msc["cfg"].loss.perceptual_crop
    x = torch.rand((2, crop, crop, 3),
                   generator=torch.Generator().manual_seed(12)) * 2 - 1
    mob, p = msc["perceptual"], msc["perc_params"]
    want = mob.features({k: v.cpu() for k, v in p.items()}, x)
    got = mob.features(p, x.to(device))
    return [rel_l2(g, w) for g, w in zip(got, want)]


def phase_mobilenet(sc: dict, steps: int) -> dict:
    """``steps`` init and split training steps at full width with the
    MobileNetV2 backbone (``mobilenet_step``, ``mobilenet_split_step``:
    the checks of ``step``), its features on the card against the CPU at
    the perceptual crop (rel-L2 1e-5 a tap), then per stage ``steps``
    turns of one conv-backbone step and one MobileNet step, each timed on
    CUDA events (the steps share the parameters and update them)."""
    import torch

    msc = mobilenet_scene(sc, "cuda")
    errs = mobilenet_features_err(msc, "cuda")
    check(max(errs) <= 1e-5, f"mobilenet: features card vs CPU {errs}")
    out = {stage: phase_step(msc, stage, steps, phase=phase)
           for stage, phase in (("init", "mobilenet_step"),
                                ("split", "mobilenet_split_step"))}
    for stage, r in out.items():
        for k, v in r["losses"].items():
            if k.endswith("normal_loss"):
                check(v > 0, f"mobilenet {stage}: {k} = {v}")
    turns = {}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for stage in ("init", "split"):
        key = STATE_KEY[stage]
        fns = {"conv": stage_step_fn(sc, stage),
               "mobilenet": stage_step_fn(msc, stage)}
        ms = {k: [] for k in fns}
        for _ in range(steps):
            for k, fn in fns.items():
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
                sc[key], _ = fn(sc[key], sc["target"], gen)
                ev[1].record()
                ev[1].synchronize()
                ms[k].append(ev[0].elapsed_time(ev[1]))
        turns[stage] = ms
    emit("mobilenet", features_rel_l2=errs,
         crop=msc["cfg"].loss.perceptual_crop, steps=steps,
         mean_ms={k: r["mean_ms"] for k, r in out.items()},
         peak_mem_gib={k: r["peak_mem_gib"] for k, r in out.items()},
         turns_ms=turns)
    return {what: {k: sum(r[what][k] for r in out.values())
                   for k in out["init"][what]}
            for what in ("launches", "calls")}


def texel_edge_distance(shape, res: int):
    """Per pixel of ``cubemap_to_latlong(cube, shape)`` at ``res`` a face,
    in float64: the least distance, in texels, of its texel coordinates
    to a texel edge, or of its direction to a tie of the major axis."""
    import numpy as np

    H, W = shape
    th = (np.arange(H) + 0.5) / H * np.pi
    ph = ((np.arange(W) + 0.5) / W - 0.5) * 2 * np.pi
    th, ph = np.meshgrid(th, ph, indexing="ij")
    d = np.stack([np.sin(th) * np.sin(ph), np.cos(th),
                  -np.sin(th) * np.cos(ph)], -1)
    ad = np.abs(d)
    major = ad.max(-1)
    srt = np.sort(ad, -1)
    tie = (srt[..., 2] - srt[..., 1]) * res
    coords = (d / major[..., None] + 1) * 0.5 * res
    # the two in-face coordinates are the two minor components, up to sign
    minor = np.where(ad == major[..., None], np.nan, coords)
    edge = np.nanmin(np.abs(minor - np.round(minor)), -1)
    return np.minimum(edge, tie)


AUX_SIZES = {"full": dict(cube=32, points=4096, tets_grid=48),
             "tiny": dict(cube=8, points=256, tets_grid=12)}


def phase_aux(sc: dict, scale: str, device: str, out_dir: str) -> dict:
    """Each API-only module once on ``device`` against the CPU (values
    abs 1e-5 + rel 1e-5, gradients rel-L2 1e-3, the gradient tolerance of
    the ticks: a clamp at its bound, as the edge loss's cosine of a flat
    fan, may pass or stop the gradient on one device): the edge normal
    consistency loss on the scene's init extraction, the dense
    ``antialias`` and the bilateral denoiser at the training resolution,
    the cubemap conversions and prefilters at AUX_SIZES' face size from
    the scene's probe, ``CondBNDecoder`` and ``LPIPSLike`` at their
    default widths (LPIPS on the perceptual crop); on the host,
    ``tetrahedralize_interior`` of the SMPL template and a material file's
    round trip. Returns the kernels' launches and calls in the device
    calls, and their kernel inputs by call site."""
    import numpy as np
    import torch

    from d3human_tpu_torch.models.condbn import CondBNDecoder
    from d3human_tpu_torch.models.perceptual import LPIPSLike
    from d3human_tpu_torch.ops.denoiser import BilateralDenoiser
    from d3human_tpu_torch.ops.mesh_ops import edge_normal_consistency_loss
    from d3human_tpu_torch.ops.rasterizer import (
        Rast, antialias, rasterize, xfm_points,
    )
    from d3human_tpu_torch.pipeline.tetrahedralize import (
        tetrahedralize_interior,
    )
    from d3human_tpu_torch.render import cubemap, material

    a = AUX_SIZES[scale]
    p, cfg = sc["params"], sc["cfg"]
    res = tuple(cfg.render.train_res)
    gen = torch.Generator().manual_seed(13)
    with torch.no_grad():
        m = sc["model"].get_meshes(p["geometry"], p["pose"], 0)
        v_clip = xfm_points(m.verts_posed, sc["target"]["mvp"])
        rast = rasterize(v_clip, m.mesh.faces, m.mesh.face_valid, res,
                         **(sc["raster_opts"] or {}))
    faces, fvalid = m.mesh.faces, m.mesh.face_valid

    def host(x):
        return tree_map(lambda t: t.detach().cpu() if isinstance(
            t, torch.Tensor) else t, x)

    # each case: (inputs made on the CPU, fn(inputs on a device) -> outputs,
    # the indices of the inputs whose gradients are compared)
    rgb = torch.rand((*res, 3), generator=gen)
    nrm = torch.nn.functional.normalize(torch.randn((*res, 3),
                                                    generator=gen), dim=-1)
    z = 1.0 + 0.1 * torch.rand((*res, 1), generator=gen)
    probe = host(p["light"]["base"]) * (torch.rand(
        tuple(p["light"]["base"].shape), generator=gen) + 0.5)
    cbn = CondBNDecoder()
    cbn_p = host(cbn.init(torch.Generator().manual_seed(14), "cpu"))
    cbn_p = tree_map(lambda t: t + 0.05 * torch.randn(
        tuple(t.shape), generator=gen), cbn_p)
    lp = LPIPSLike()
    lp_p = host(lp.init(None, "cpu"))
    crop = cfg.loss.perceptual_crop
    cases = {
        "edge_normal_consistency": (
            [host(m.verts_posed), host(faces), host(fvalid)],
            lambda v, f, w: edge_normal_consistency_loss(v, f, w), [0]),
        "antialias": (
            [torch.rand((*res, 4), generator=gen), host(v_clip), host(faces),
             host(rast.tri_id), host(rast.zbuf)],
            lambda c, v, f, ti, zb: antialias(c, v, f, Rast(ti, zb)), [0, 1]),
        "denoiser": (
            [rgb, nrm, z], lambda c, n, d: BilateralDenoiser()(c, n, d),
            [0]),
        "cubemap": (
            [probe, torch.rand((6, a["cube"], a["cube"], 3), generator=gen)],
            lambda ll, cube: (
                cubemap.latlong_to_cubemap(ll, a["cube"]),
                cubemap.diffuse_prefilter(cube),
                cubemap.specular_prefilter(cube, 0.5),
                *cubemap.specular_mip_chain(cube, 4)), [0, 1]),
        # nearest texel: held below by the texel edges' float64 distance
        "cubemap_to_latlong": (
            [torch.rand((6, a["cube"], a["cube"], 3), generator=gen)],
            lambda cube: cubemap.cubemap_to_latlong(
                cube, (2 * a["cube"], 4 * a["cube"])), [0]),
        "condbn": (
            [cbn_p, torch.randn((2, a["points"], 3), generator=gen),
             torch.randn((2, cbn.latent_dim), generator=gen)],
            lambda q, x, c: cbn.apply(q, x, c), [1]),
        "lpips": (
            [lp_p, torch.rand((1, crop, crop, 3), generator=gen),
             torch.rand((1, crop, crop, 3), generator=gen)],
            lambda q, x, y: lp.distance(q, x, y), [1]),
    }
    def run(name, dev):
        args, fn, wrt = cases[name]
        xs = [tree_map(lambda t: t.detach().to(dev).requires_grad_(i in wrt)
                       if isinstance(t, torch.Tensor) else t, x)
              for i, x in enumerate(args)]
        outs, secs = timed(dev, lambda: fn(*xs))
        outs = outs if isinstance(outs, tuple) else (outs,)
        wts = [torch.randn(tuple(o.shape), generator=torch.Generator()
                           .manual_seed(15)).to(dev) for o in outs]
        sum((o * w).sum() for o, w in zip(outs, wts)).backward()
        sync(dev)
        return dict(outs=[o.detach().cpu() for o in outs], secs=secs,
                    grads=[xs[i].grad.detach().cpu() for i in wrt])

    # the device's calls first (recorded by call site on the card), then
    # the CPU's
    reset_counts()
    with (recording_kernel_inputs() if device == "cuda"
          else contextlib.nullcontext({})) as inputs:
        got = {name: run(name, device) for name in cases}
    counts = read_counts()
    calls = counts.pop("calls")
    report = {}
    for name in cases:
        want = run(name, "cpu")
        g = got[name]
        if name == "cubemap_to_latlong":
            # a lookup whose texel coordinate lies within float32 rounding
            # of a texel's edge may take the neighbour on one device
            moved = (g["outs"][0] != want["outs"][0]).any(-1).numpy()
            near = texel_edge_distance(moved.shape, a["cube"]) < 1e-3
            check(bool((near | ~moved).all()),
                  f"aux {name}: {int((moved & ~near).sum())} pixels took "
                  "another texel away from any texel edge")
            report[name + "_edge_pixels_moved"] = int(moved.sum())
            g = dict(g, outs=[torch.where(torch.as_tensor(moved)[..., None],
                                          want["outs"][0], g["outs"][0])],
                     grads=want["grads"] if moved.any() else g["grads"])
        err = max(float((a - b).abs().max())
                  for a, b in zip(g["outs"], want["outs"]))
        g_err = max(rel_l2(a, b) for a, b in zip(g["grads"], want["grads"]))
        check(all(bool(((a - b).abs() <= 1e-5 + 1e-5 * b.abs()).all())
                  for a, b in zip(g["outs"], want["outs"])),
              f"aux {name}: {err} beyond abs 1e-5 + rel 1e-5")
        check(g_err <= 1e-3, f"aux {name}: gradient rel-L2 {g_err}")
        check(all(float(a.abs().max()) > 0 for a in g["grads"]),
              f"aux {name}: a zero gradient")
        report[name] = dict(max_abs_err=err, grad_rel_l2=g_err,
                            seconds=g["secs"], cpu_seconds=want["secs"],
                            shapes=[list(o.shape) for o in g["outs"]])
    if device == "cuda":
        check(counts["coo_scatter_add"] > 0, "aux: the scatter never "
              "launched")
    canon = sc["scene"].canon.vs_template[0].detach().cpu().numpy()
    tri = np.asarray(sc["scene"].model.faces, np.int64)
    (tv, tt), tet_s = timed("cpu", lambda: tetrahedralize_interior(
        canon, tri, grid_res=a["tets_grid"]))
    check(len(tt) > 0 and int(tt.max()) < len(tv),
          "aux: tetrahedralize_interior gave no tets")
    mat = {"name": "skin", "bsdf": "pbr", "kd": [0.8, 0.5, 0.25],
           "ks": [0.0, 0.5, 0.1]}
    path = os.path.join(out_dir, "aux", "skin.mtl")
    material.save_mtl(path, mat)
    back = material.load_mtl(path)[0]
    check(back["name"] == "skin" and back["bsdf"] == "pbr"
          and np.allclose(back["kd"], mat["kd"])
          and np.allclose(back["ks"], mat["ks"]),
          f"aux: the material round trip gave {back}")
    report["tetrahedralize_interior"] = dict(
        verts=len(canon), faces=len(tri), tet_verts=len(tv), tets=len(tt),
        grid_res=a["tets_grid"], seconds=tet_s)
    report["material"] = dict(bytes=os.path.getsize(path))
    emit("aux", tolerance="abs 1e-5 + rel 1e-5, gradients rel-L2 1e-3",
         faces=int(faces.shape[0]), live_faces=int(fvalid.sum()),
         resolution=list(res), launches=counts, calls=calls, **report)
    return dict(launches=counts, calls=calls, inputs=inputs)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed(device, fn):
    """(fn(), seconds) with the device synchronised on both ends."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def peak_gib(device):
    import torch

    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2 ** 30


def reset_peak(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def phase_field_setup(sc: dict, scale: str, steps: int) -> dict:
    """The field set-up between stages on a copy of the scene's geometry
    parameters (no later phase sees it): the SMPL template's SDF target by
    the tensor op against the native engine, the two pretrainings, the
    re-initialisation, and the chunked SDF query against the unchunked
    one."""
    import numpy as np
    import torch

    from d3human_tpu_torch.models.geometry import GeometryModel
    from d3human_tpu_torch.native.meshsdf import MeshSDF

    model = sc["model"]
    grid, dev = model.grid, model.grid.verts.device
    g = tree_map(torch.clone, sc["params"]["geometry"])
    target, sdf_s = timed(dev, model.smpl_template_sdf)
    verts = model.canon.vs_template[0].cpu().numpy()
    faces = np.asarray(model.deformer.model.faces)
    native, native_s = timed(dev, lambda: MeshSDF(verts, faces).query(
        grid.verts.cpu().numpy(), sign_convention="pos_inside"))
    dev_sdf = target.cpu().numpy()
    diff = float(np.abs(dev_sdf - native).max())
    far = np.abs(native) > 0.01
    sign_bad = int((np.sign(dev_sdf[far]) != np.sign(native[far])).sum())
    check(diff < 5e-3, f"field_setup: tensor SDF vs native engine {diff}")
    check(sign_bad == 0, f"field_setup: {sign_bad} signs differ")

    code = torch.zeros((1, 1, sc["cfg"].field.pose_code_dim), device=dev)

    def sdf_loss(p):
        with torch.no_grad():
            return float(((model.sdf_mlp.apply(p["sdf_net"], grid.verts)
                           [..., 0] - target) ** 2).mean())

    def zero_loss(p):
        with torch.no_grad():
            return float((model.nonrigid.apply(p["nonrigid"], grid.verts,
                                               code) ** 2).mean())

    sdf0, zero0 = sdf_loss(g), zero_loss(g)
    (g, _), sdf_fit_s = timed(dev, lambda: model.pretrain_sdf(
        g, target, steps=steps))
    g, zero_fit_s = timed(dev, lambda: model.pretrain_nonrigid_zero(
        g, steps=steps))
    sdf1, zero1 = sdf_loss(g), zero_loss(g)
    check(sdf1 < sdf0, f"field_setup: pretrain_sdf loss {sdf0} -> {sdf1}")
    check(zero1 < zero0,
          f"field_setup: pretrain_nonrigid_zero loss {zero0} -> {zero1}")
    fresh = model.reinit_fields(torch.Generator().manual_seed(5), g)
    check(fresh["msdf"].shape == g["msdf"].shape
          and float(fresh["msdf"].min()) >= -0.01
          and float(fresh["msdf"].max()) <= 1.0
          and [lay["w"].shape for lay in fresh["sdf_net"]["layers"]]
          == [lay["w"].shape for lay in g["sdf_net"]["layers"]],
          "field_setup: reinit_fields shapes or ranges")

    chunk = SCALES[scale]["sdf_chunk"]
    cfg = sc["cfg"]
    chunked = GeometryModel(cfg.replace(geometry=dataclasses.replace(
        cfg.geometry, sdf_chunk=chunk)), grid, model.deformer, model.canon)
    w = torch.randn((grid.n_verts,), generator=torch.Generator()
                    .manual_seed(6)).to(dev)
    query = {}
    for name, m in (("unchunked", model), ("chunked", chunked)):
        net = {"layers": [{k: t.detach().clone().requires_grad_(True)
                           for k, t in lay.items()}
                          for lay in g["sdf_net"]["layers"]]}
        leaves = [t for lay in net["layers"] for t in (lay["w"], lay["b"])]

        def run(m=m, net=net, leaves=leaves):
            out = m.query_sdf({"sdf_net": net}, grid.verts)
            grads = torch.autograd.grad((out * w).sum(), leaves)
            return out.detach(), torch.cat([x.reshape(-1) for x in grads])

        run()
        reset_peak(dev)
        (out, grad), secs = timed(dev, run)
        query[name] = dict(out=out, grad=grad, ms=secs * 1e3,
                           peak_mem_gib=peak_gib(dev))
    a, b = query["chunked"], query["unchunked"]
    fwd_rel = float((a["out"] - b["out"]).abs().max() / b["out"].abs().max())
    grad_rel = float(torch.linalg.norm(a["grad"] - b["grad"])
                     / torch.linalg.norm(b["grad"]))
    check(fwd_rel <= 1e-6, f"field_setup: chunked query forward {fwd_rel}")
    check(grad_rel <= 1e-5, f"field_setup: chunked query grad {grad_rel}")
    out = dict(points=grid.n_verts, template_faces=len(faces),
               smpl_template_sdf_s=sdf_s, native_engine_s=native_s,
               tensor_vs_native_max_abs=diff, tolerance="abs 5e-3",
               signs_compared=int(far.sum()), steps=steps,
               pretrain_sdf_ms_per_step=sdf_fit_s * 1e3 / steps,
               pretrain_sdf_loss=[sdf0, sdf1],
               pretrain_nonrigid_zero_ms_per_step=zero_fit_s * 1e3 / steps,
               pretrain_nonrigid_zero_loss=[zero0, zero1],
               sdf_chunk=chunk, chunked_forward_rel=fwd_rel,
               chunked_grad_rel_l2=grad_rel,
               query_fwd_bwd={k: dict(ms=v["ms"],
                                      peak_mem_gib=v["peak_mem_gib"])
                              for k, v in query.items()})
    del g, fresh, query, a, b, target, chunked
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    emit("field_setup", **out)
    return out


SURGERY_DIR = "d3human_tpu_torch/build/smoke_surgery"


def consistent_winding(faces) -> float:
    """Share of the interior edges (edges of two faces) that the two faces
    run in opposite directions: 1 for a consistently wound mesh."""
    import numpy as np

    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    _, inv, cnt = np.unique(np.sort(e, axis=1), axis=0, return_inverse=True,
                            return_counts=True)
    ups = np.bincount(inv.reshape(-1), weights=e[:, 0] < e[:, 1])
    two = cnt == 2
    return float((ups[two] == 1).mean()) if two.any() else 1.0


@contextlib.contextmanager
def recording_kernel_inputs(tag=None):
    """While active, every call of the kernels' wrappers (first_k_indices,
    coo_scatter_add, resolve_tiles) is recorded by call site,
    wherever the caller took the name from (``sys.monitoring`` on the
    wrappers' code, nothing patched). A scatter call's site is the first
    caller outside ``ops/scatter.py`` and torch (``mesh_ops.py:42`` for
    the normals' segment add), except in a backward, whose site is the
    backward's own line; a resolve call's site gains ``tag()`` (the stage)
    and ``peel`` when it has a floor. Yields {kernel: {site: {"calls": n,
    "args": a copy of the site's biggest call}}}: first_k's (mask, k,
    fill) with the largest (k, n), the scatter's (idx, vals, out_rows,
    sorted) with the most values, the resolve's (rows, faces, starts,
    big_base, n_big, ntx, floor) with the largest (F, slots); a kernel
    never called has no key."""
    import torch

    from d3human_tpu_torch.ops import compaction, raster_resolve, scatter

    mon = sys.monitoring
    tool = next(i for i in range(6) if mon.get_tool(i) is None)
    seen = {}
    codes = {compaction.first_k_indices.__code__: "first_k_indices",
             scatter.coo_scatter_add.__code__: "coo_scatter_add",
             raster_resolve.resolve_tiles.__code__: "resolve_tiles"}
    skip = (os.path.abspath(scatter.__file__),
            os.path.dirname(os.path.abspath(torch.__file__)))

    def where(f):
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"

    def site_of(kernel, caller):
        if kernel != "coo_scatter_add" or caller.f_code.co_name == "backward":
            return where(caller)
        f = caller
        while f is not None and os.path.abspath(
                f.f_code.co_filename).startswith(skip):
            f = f.f_back
        return where(f if f is not None else caller)

    def copy(x):
        if isinstance(x, tuple):
            return tuple(copy(y) for y in x)
        return x.detach().clone() if isinstance(x, torch.Tensor) else x

    def on_start(code, offset):
        kernel = codes.get(code)
        if kernel is None:
            return
        frame = sys._getframe(1)               # the wrapper's own frame
        a = frame.f_locals
        site = site_of(kernel, frame.f_back)
        if kernel == "first_k_indices":
            size, args = (a["k"], a["mask"].numel()), (
                a["mask"], a["k"], a["fill_value"])
        elif kernel == "coo_scatter_add":
            size, args = a["vals"].numel(), (
                a["idx"], a["vals"], a["out_rows"], a["sorted_idx"])
        else:
            site += (f" {tag()}" if tag else "") + (
                " peel" if a["floor"] is not None else "")
            size, args = (a["rows"].shape[0], a["faces"].numel()), (
                a["rows"], a["faces"], a["starts"], a["big_base"],
                a["n_big"], a["ntx"], a["floor"])
        s = seen.setdefault(kernel, {}).setdefault(site, dict(calls=0,
                                                             size=None))
        s["calls"] += 1
        if s["size"] is None or size > s["size"]:
            s["size"], s["args"] = size, copy(args)

    mon.use_tool_id(tool, "chip_smoke")
    mon.register_callback(tool, mon.events.PY_START, on_start)
    for code in codes:
        mon.set_local_events(tool, code, mon.events.PY_START)
    try:
        yield seen
    finally:
        for code in codes:
            mon.set_local_events(tool, code, 0)
        mon.register_callback(tool, mon.events.PY_START, None)
        mon.free_tool_id(tool)


def check_scatter_values(what: str, idx, vals, rows_out: int,
                         srt: bool = False) -> dict:
    """The scatter on the rows a call site really summed: within rel 1e-5
    / abs 1e-6 of the plain version (the kernels' order of additions), and
    within the error bound of a float32 sum of k terms in any order,
    (k - 1) * 2^-24 * sum|terms| per row, of the float64 sum. Real rows can
    cancel (a vertex's face normals of both windings), so another order
    alone can move such a sum by more than the random rows' 1e-4: the
    library's distance to the float64 sum is reported beside the
    kernel's."""
    import torch

    from d3human_tpu_torch.ops import scatter

    got = scatter.coo_scatter_add(idx, vals, rows_out, sorted_idx=srt)
    want = scatter.coo_scatter_add_plain(idx, vals, rows_out, srt)
    err = (got - want).abs()
    check(bool((err <= 1e-6 + 1e-5 * want.abs()).all()),
          f"scatter {what} (recorded rows): max err {float(err.max())}")
    didx = torch.where((idx >= 0) & (idx < rows_out), idx, rows_out).long()

    def row_sum(v):
        return torch.zeros((rows_out + 1, v.shape[1]), dtype=v.dtype,
                           device=v.device).index_add_(0, didx, v)[:rows_out]

    exact = row_sum(vals.double())
    k = torch.bincount(didx, minlength=rows_out + 1)[:rows_out].double()
    # the float64 sum's own error, (k - 1) * 2^-53 * sum|terms|, is added
    bound = ((k - 1).clamp_min(0) * (2.0 ** -24 + 2.0 ** -52))[:, None] \
        * row_sum(vals.double().abs())
    e_kernel = (got.double() - exact).abs()
    e_library = (row_sum(vals).double() - exact).abs()
    check(bool((e_kernel <= bound).all()),
          f"scatter {what} (recorded rows): {float(e_kernel.max())} from "
          f"the float64 sum, beyond the float32 bound")
    return dict(N=idx.numel(), C=vals.shape[1], out_rows=rows_out,
                bitwise=torch.equal(got, want), max_abs_err=float(err.max()),
                max_rows_per_out_row=int(k.max()),
                kernel_vs_float64=float(e_kernel.max()),
                library_vs_float64=float(e_library.max()),
                kernel_vs_library=float((got - row_sum(vals)).abs().max()),
                float32_bound_max=float(bound.max()))


def check_recorded(label: str, inputs: dict, gen) -> dict:
    """The kernels at inputs recorded by ``recording_kernel_inputs``,
    outside the counted runs: first_k at each call site's biggest call
    (exactly equal to its plain version and faster than the library), the
    scatter at each site's biggest call on the site's indices with random
    rows, as at every other shape, and on its recorded rows, the resolve
    at each site's biggest binning (exactly equal to the plain full scan,
    with its floor where it had one); the scatter and the resolve timed
    beside the library and not held to it (ROADMAP Queue 2 item 8).
    Returns {kernel: {site: report}}."""
    import torch

    from d3human_tpu_torch.ops.rasterizer import Binned

    out = {"first_k_indices": {}, "coo_scatter_add": {},
           "resolve_tiles": {}}
    for site, s in inputs.get("first_k_indices", {}).items():
        mask, k, fill = s["args"]
        check(fill == mask.numel(), f"first_k at {site}: fill {fill}")
        out["first_k_indices"][site] = check_first_k(
            f"{label} {site}", mask, k)
    for site, s in inputs.get("coo_scatter_add", {}).items():
        idx, vals, out_rows, srt = s["args"]
        what = f"{label} {site}"
        r = check_scatter(what, idx, torch.ones(
            (idx.numel(),), dtype=torch.bool, device=idx.device),
            vals.shape[1], out_rows, srt, gen, faster=False)
        r["recorded_rows"] = check_scatter_values(what, idx, vals, out_rows,
                                                  srt)
        out["coo_scatter_add"][site] = r
    for site, s in inputs.get("resolve_tiles", {}).items():
        rows, faces, starts, big_base, n_big, ntx, floor = s["args"]
        NT = starts.shape[0] - 1
        binned = Binned(rows=rows, faces=faces, starts=starts,
                        big_base=big_base, n_big=n_big,
                        grid=(NT // ntx, ntx, NT))
        _, r = check_resolve(binned, floor=floor)
        out["resolve_tiles"][site] = dict(r, faces=rows.shape[0] - 1)
    return out


def add_recorded_rows(rows: list, key: str, got: dict) -> None:
    """Each kernel row gains ``key``: {site: the numbers at the site's
    recorded call} (the resolve's peel sites in the peel row)."""
    by_name = {r["name"]: r for r in rows}
    by_name["first_k_indices"][key] = {
        site: dict(kernel_summary(r), shape=f"n={r['n']} k={r['k']}")
        for site, r in got["first_k_indices"].items()}
    by_name["coo_scatter_add"][key] = {
        site: dict(kernel_summary(r), shape=(
            f"N={r['N']} C={r['C']} out={r['out_rows']}"))
        for site, r in got["coo_scatter_add"].items()}
    for name, peel in (("resolve_tiles", False), ("resolve_tiles_peel", True)):
        res = {site: dict(kernel_summary(r), library_ms=None, shape=(
            f"F={r['faces']} NT={r['NT']} longest={r['longest_list']} "
            f"live={r['live_slots']}"))
            for site, r in got["resolve_tiles"].items()
            if site.endswith(" peel") == peel}
        if res:
            by_name[name][key] = res


def phase_surgery_kernels(rows: list, inputs: dict, ssc: dict) -> None:
    """The kernels at the surgery's own inputs (``check_recorded``), and
    the resolve on the surgery template's binning at the seq step's
    resolution (oversize faces in the shared list), held to its plain
    version as in the kernels phase. Adds to those kernels' rows a
    ``surgery`` entry (the resolve's: ``surgery_seq_step``)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    got = check_recorded("surgery", inputs, gen)
    seq = seq_kernel_inputs(ssc)
    F = ssc["seq_template"].f.shape[0]
    stats = binning_stats(seq["binned"], seq["v_clip"], ssc["seq_template"].f,
                          seq["fvalid"], seq["res"])
    _, rs = check_resolve(seq["binned"])
    emit("surgery_kernels", exact_first_k_and_resolve=True,
         scatter_tolerance="rel 1e-5 abs 1e-6",
         calls_by_site={k: {site: s["calls"] for site, s in v.items()}
                        for k, v in inputs.items()},
         first_k=got["first_k_indices"], scatter=got["coo_scatter_add"],
         resolve=dict(rs, faces=F, binning=stats))
    add_recorded_rows(rows, "surgery", got)
    by_name = {r["name"]: r for r in rows}
    by_name["resolve_tiles"]["surgery_seq_step"] = dict(
        kernel_summary(rs), library_ms=None,
        shape=(f"NT={rs['NT']} longest={rs['longest_list']} "
               f"live={rs['live_slots']}"),
        n_global=stats["n_global"], longest_list=stats["longest_list"])


def phase_cli_kernels(rows: list, inputs: dict, key: str = "cli") -> None:
    """The kernels at a CLI run's own inputs (``check_recorded``: every
    first_k and scatter call site's biggest call of the run, each stage's
    biggest resolve call, the seq stage's on the seq template's binning):
    phase ``<key>_kernels``. Adds to those kernels' rows a ``key`` entry
    (``cli`` for the synthetic run, ``capture`` for the capture's)."""
    check(set(inputs) == {"first_k_indices", "coo_scatter_add",
                          "resolve_tiles"},
          f"{key}_kernels: recorded calls of {sorted(inputs)}")
    check(any(site.endswith(" seq") for site in inputs[
        "resolve_tiles"]),
          f"{key}_kernels: no resolve call of the seq stage")
    phase_path_kernels(rows, inputs, key)


def phase_path_kernels(rows: list, inputs: dict, key: str) -> None:
    """The kernels at a path's recorded inputs (``check_recorded``):
    phase ``<key>_kernels``; each kernel the path called gains a ``key``
    entry in its row."""
    import torch

    got = check_recorded(key, inputs, torch.Generator(
        device="cuda").manual_seed(4))
    emit(f"{key}_kernels", exact_first_k_and_resolve=True,
         scatter_tolerance="rel 1e-5 abs 1e-6",
         calls_by_site={k: {site: s["calls"] for site, s in v.items()}
                        for k, v in inputs.items()},
         first_k=got["first_k_indices"], scatter=got["coo_scatter_add"],
         resolve=got["resolve_tiles"])
    add_recorded_rows(rows, key, got)


def phase_surgery(sc: dict, out_dir: str) -> dict:
    """The JAX package's route from the split stage to the seq template
    (train_d3h.py, the split stage's end) on the scene's parameters, files
    under ``out_dir``; kernel counts reset just before and read just after,
    the kernels' inputs recorded by call site. Returns the launches and
    calls, the template and the recorded inputs."""
    import shutil

    import numpy as np

    from d3human_tpu_torch.ops import mesh_sdf
    from d3human_tpu_torch.pipeline.components import process_close_hole
    from d3human_tpu_torch.pipeline.template import (
        build_seq_template, merge_body_cloth,
    )
    from d3human_tpu_torch.train.stages import export_stage_meshes
    from d3human_tpu_torch.utils import io as mesh_io

    model, cfg = sc["model"], sc["cfg"]
    dev = model.grid.verts.device
    shutil.rmtree(out_dir, ignore_errors=True)
    join = os.path.join
    for k in mesh_sdf.ENGINE_COUNTS:
        mesh_sdf.ENGINE_COUNTS[k] = 0
    sync(dev)
    reset_counts()
    secs = {}
    with recording_kernel_inputs() as inputs:
        paths, secs["export_stage_meshes"] = timed(dev, lambda: (
            export_stage_meshes(model, sc["params"],
                                join(out_dir, "split_cloth0"), "final")))
        ch, secs["process_close_hole"] = timed(dev, lambda: (
            process_close_hole(join(out_dir, "close_hole_split_cloth0"),
                               paths["body"], paths["cloth"])))
        smpl_path = join(out_dir, "smpl_template.obj")
        _, secs["smpl_template_obj"] = timed(dev, lambda: mesh_io.write_obj(
            smpl_path, model.canon.vs_template[0],
            model.deformer.model.faces))
        process_dir = join(out_dir, "processsplit_cloth0")
        merge, secs["merge_body_cloth"] = timed(dev, lambda: merge_body_cloth(
            process_dir, ch["body"], ch["cloth"],
            grid_res=min(96, cfg.geometry.grid_res), smpl_obj=smpl_path,
            bbox_npz=ch["bbox"], device=dev))
        template, secs["build_seq_template"] = timed(
            dev, lambda: build_seq_template(process_dir, device=dev))
    n = read_counts()
    calls = n.pop("calls")
    engines = dict(mesh_sdf.ENGINE_COUNTS)

    halves = {}
    for k in ("cloth", "body", "watertight"):
        v, f = mesh_io.load_obj(paths[k])
        halves[k] = dict(verts=len(v), faces=len(f),
                         consistent_winding=consistent_winding(f))
    for k in ("cloth", "body"):
        v, f = mesh_io.load_obj(ch[k])
        halves[k + "_after_close_hole"] = dict(verts=len(v), faces=len(f))
    lab = template.face_labels.cpu().numpy()
    c = merge["counts"]
    check(c["merged_faces"] < 1 << 20,
          f"surgery: {c['merged_faces']} merged faces")
    check(int((lab == 0).sum()) > 0 and int((lab == 1).sum()) > 0,
          "surgery: a label of the merged template is empty")
    check(engines["device"] == 0 and engines["native"] > 0,
          f"surgery: host SDF queries answered by {engines}")
    # the wrappers count launches on the card only
    check(dev.type != "cuda" or (n["first_k_indices"] > 0
                                 and n["coo_scatter_add"] > 0),
          f"surgery: launches {n}")
    # every counted call went through a recorded call site
    recorded = {k: sum(s["calls"] for s in v.values())
                for k, v in inputs.items()}
    check(dev.type != "cuda" or all(recorded[k] == calls[k]
                                    for k in recorded),
          f"surgery: recorded calls {recorded}, counted {calls}")
    out = dict(seconds=secs, total_s=sum(secs.values()), halves=halves,
               components=ch["components"], merge=c, branch=merge["branch"],
               branch_error=merge.get("error"), engines=engines,
               template=dict(n_verts=int(template.v.shape[0]),
                             n_faces=int(template.f.shape[0]),
                             cloth_faces=int((lab == 1).sum()),
                             body_faces=int((lab == 0).sum()),
                             cloth_verts=int(template.cloth_vidx.shape[0]),
                             body_verts=int(template.body_vidx.shape[0]),
                             adjacent_pairs=int(
                                 template.connected_faces.shape[0])),
               launches=n, calls=calls, recorded_calls=recorded)
    emit("surgery", **out)
    return dict(launches=n, calls=calls, template=template, inputs=inputs)


def surgery_scene(sc: dict, template) -> dict:
    """The scene with the surgery's template as its seq template and a
    seq state on a copy of the parameters (no other phase sees its
    steps)."""
    from d3human_tpu_torch.train.step import init_state

    params = tree_map(lambda t: t.clone(), sc["params"])
    return dict(sc, params=params, seq_template=template,
                seq_state=init_state("seq", params, sc["seq_cfg"]))


def profiled_fit(sc: dict, steps: int) -> None:
    """``pretrain_sdf`` of the scene's SDF MLP toward the capsule at every
    lattice vertex, on a copy of its layers (the scene keeps its own)."""
    from d3human_tpu_torch.data.synthetic import capsule_sdf

    model = sc["model"]
    model.pretrain_sdf(sc["params"]["geometry"],
                       capsule_sdf(model.grid.verts), steps=steps)


def one_more_step(sc: dict, stage: str) -> None:
    import torch

    key = STATE_KEY[stage]
    sc[key], _ = stage_step_fn(sc, stage)(
        sc[key], sc["target"], torch.Generator(device="cuda").manual_seed(1))


# ---------------------------------------------------------------- the CLI

GT_SCALES = {"full": dict(res=(1080, 1080), frames=4),
             "tiny": dict(res=(48, 48), frames=2)}
# the CLI phase: a copy of the source config with the stated cuts (keys of
# its sections; a section's key wins over a flat key), the
# synthetic capture's frame count, --iters-scale, and the Chamfer samples
# of PARITY.json (None: the CLI's own)
CLI_SCALES = {
    "full": dict(config="configs/f3c_synth_full20.json", frames=4,
                 iters_scale=0.002,
                 cuts={"stages": {"sdf_mlp_pretrain_steps": 100,
                                  "sdf_deform_pretrain_steps": 50}},
                 parity_samples=None),
    "tiny": dict(config="configs/smoke.json", frames=2, iters_scale=0.002,
                 cuts={"stages": {"sdf_mlp_pretrain_steps": 100,
                                  "sdf_deform_pretrain_steps": 20},
                       "geometry": {"grid_crop": 0.1},
                       "render": {"train_res": [48, 48],
                                  "texture_res": [48, 48]}},
                 parity_samples=2000),
}
CLI_DIR = "d3human_tpu_torch/build/smoke_cli"
CLI_STAGE_DIRS = {"split_smpl": "split_smpl", "init": "init",
                  "split": "split_cloth0", "seq": "seq"}
GT_TOL = 2e-3            # CachedTargets against frame_target (fp16)


def phase_gt_targets(scale: str, device: str) -> dict:
    """The synthetic ground truth: ``frame_target`` of every frame through
    the oracle rasterizer (ms per frame, peak memory); the oracle's
    ``tri_id`` against the binned rasterizer's (the resolve kernel on the
    card) on frame 0's clip-space body: coverage equal, ids equal on at
    least 99.9 % of the covered pixels (the kernel's keys quantize depth,
    so near-ties at shared edges may break the other way); the fp16
    ``CachedTargets`` against ``frame_target`` per buffer within
    ``GT_TOL``."""
    import numpy as np
    import torch

    from d3human_tpu_torch.data.synthetic import CachedTargets, make_scene
    from d3human_tpu_torch.ops.rasterizer import (
        rasterize, rasterize_bruteforce, xfm_points,
    )

    s = GT_SCALES[scale]
    scene = make_scene(s["res"], n_frames=s["frames"], device=device)
    scene.frame_target(0)                                  # warm-up
    reset_peak(device)
    frame_ms = [timed(device, lambda i=i: scene.frame_target(i))[1] * 1e3
                for i in range(s["frames"])]
    peak = peak_gib(device)

    pp = scene.pose_params
    with torch.no_grad():
        v, _, _ = scene.model.forward(
            betas=pp["shape"], root_pose=pp["root_pose"][:1],
            body_pose=pp["body_pose"][:1], transl=pp["trans"][:1])
        faces = torch.as_tensor(np.asarray(scene.model.faces),
                                dtype=torch.int32, device=device)
        v_clip = xfm_points(v[0], scene.mvp)
        live = torch.ones((faces.shape[0],), dtype=torch.bool, device=device)
        oracle = rasterize_bruteforce(v_clip, faces, live, s["res"])
        binned = rasterize(v_clip, faces, live, s["res"])
    cov_o, cov_b = oracle.tri_id > 0, binned.tri_id > 0
    n_cov = int(cov_o.sum())
    n_diff = int((cov_o & (oracle.tri_id != binned.tri_id)).sum())
    check(bool(torch.equal(cov_o, cov_b)),
          f"gt_targets: coverage differs on "
          f"{int((cov_o != cov_b).sum())} pixels")
    check(n_cov > 0 and n_diff <= 1e-3 * n_cov,
          f"gt_targets: tri_id differs on {n_diff} of {n_cov} pixels")

    reset_peak(device)
    cache, build_s = timed(device, lambda: CachedTargets(scene))
    cache_peak = peak_gib(device)
    err = {}
    for i in range(s["frames"]):
        want, got = scene.frame_target(i), cache.frame_target(i)
        for k, w in want.items():
            if isinstance(w, torch.Tensor) and w.dim() == 3:
                e = float((got[k] - w).abs().max())
                err[k] = max(err.get(k, 0.0), e)
        check(got["frame_idx"] == want["frame_idx"] == i,
              f"gt_targets: frame index {got['frame_idx']}")
    check(max(err.values()) <= GT_TOL,
          f"gt_targets: cache against frame_target {err}")
    out = dict(resolution=list(s["res"]), frames=s["frames"],
               faces=int(faces.shape[0]), frame_ms=frame_ms,
               mean_frame_ms=sum(frame_ms) / len(frame_ms),
               peak_mem_gib=peak, covered_pixels=n_cov,
               tri_id_differs=n_diff, coverage_equal=True,
               cache_build_s=build_s,
               cache_mib=cache._cache.numel() * 2 / 2 ** 20,
               cache_peak_mem_gib=cache_peak, cache_max_abs_err=err,
               cache_tolerance=f"abs {GT_TOL}")
    emit("gt_targets", **out)
    return out


class _Tee:
    """Standard output kept as it goes by."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.lines)


class CutRun(Exception):
    """Raised by ``instrumented_cli(stop_at=n)`` as the run enters its
    training step number n (counted from 0 over all stages)."""


@contextlib.contextmanager
def instrumented_cli(device: str, stop_at: int = None):
    """The CLI module with its stage drivers, its step builder and its
    data wrapped: per stage the seconds, the peak memory, the kernel
    counts, every step's and every target's time (the synthetic ground
    truth's render or the capture's ``frame_target``, without the
    background that the CLI composites after it) on the device's clock
    (CUDA events on the card) and on the host's, every capture decode's
    host time, and the number of steps. With ``stop_at`` the run is cut
    (``CutRun``) as it enters its training step number ``stop_at``.
    Yields (module, record); the wrappers are removed on exit."""
    import torch

    import d3human_tpu_torch.train_d3h as cli
    from d3human_tpu_torch.data.dataset import FrameDataset
    from d3human_tpu_torch.data.synthetic import SyntheticScene

    cuda = torch.device(device).type == "cuda"
    rec = {"stages": {}, "current": None, "steps": 0, "peak_gib": None}

    def keep_peak():
        p = peak_gib(device)
        if p is not None:
            rec["peak_gib"] = max(rec["peak_gib"] or 0.0, p)

    def clock():
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def stage_rec():
        return rec["stages"].setdefault(rec["current"] or "startup", dict(
            steps=[], gt=[], gt_host=[], decode=[]))

    def timing(fn, key, count=False):
        def run(*args, **kw):
            if count and rec["steps"] == stop_at:
                raise CutRun(f"cut at step {stop_at}")
            h0, t0 = time.perf_counter(), clock()
            out = fn(*args, **kw)
            r = stage_rec()
            r[key].append((t0, clock()))
            if key == "gt":
                r["gt_host"].append((h0, time.perf_counter()))
            if count:
                rec["steps"] += 1
            return out
        return run

    def driver(fn, name_of):
        def run(*args, **kw):
            rec["current"] = name_of(args)
            r = stage_rec()
            sync(device)
            keep_peak()
            reset_peak(device)
            c0 = read_counts()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync(device)
            r["seconds"] = time.perf_counter() - t0
            r["peak_mem_gib"] = peak_gib(device)
            keep_peak()
            c1 = read_counts()
            r["launches"] = {k: c1[k] - c0[k] for k in c1 if k != "calls"}
            r["calls"] = {k: c1["calls"][k] - c0["calls"][k]
                          for k in c1["calls"]}
            rec["current"] = None
            return out
        return run

    def decoding(fn):
        """The host's clock around a decode that is not the kept frame."""
        def run(self, idx):
            kept = self._last[0] == idx
            t0 = time.perf_counter()
            out = fn(self, idx)
            if not kept:
                stage_rec()["decode"].append((t0, time.perf_counter()))
            return out
        return run

    orig = (cli.make_train_step, cli.run_stage, cli.run_seq_stage,
            SyntheticScene.frame_target, FrameDataset.frame_target,
            FrameDataset.decode)
    cli.make_train_step = lambda *a, **kw: timing(orig[0](*a, **kw), "steps",
                                                   count=True)
    cli.run_stage = driver(orig[1], lambda a: a[0])
    cli.run_seq_stage = driver(orig[2], lambda a: "seq")
    SyntheticScene.frame_target = timing(orig[3], "gt")
    FrameDataset.frame_target = timing(orig[4], "gt")
    FrameDataset.decode = decoding(orig[5])
    try:
        yield cli, rec
    finally:
        (cli.make_train_step, cli.run_stage, cli.run_seq_stage,
         SyntheticScene.frame_target, FrameDataset.frame_target,
         FrameDataset.decode) = orig


def _ms(device, pairs) -> list:
    """Milliseconds of (start, end) pairs: CUDA events or host clocks."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return [(b - a) * 1e3 if isinstance(a, float) else a.elapsed_time(b)
            for a, b in pairs]


def run_cli(cli, argv: list, parity_samples) -> str:
    """``main(argv)`` in this process, its standard output kept."""
    saved = cli.PARITY_SAMPLES
    if parity_samples is not None:
        cli.PARITY_SAMPLES = parity_samples
    tee = _Tee(sys.stdout)
    try:
        with contextlib.redirect_stdout(tee):
            rc = cli.main(argv)
    finally:
        cli.PARITY_SAMPLES = saved
    check(rc == 0, f"cli: main returned {rc}")
    return tee.text()


def _read_jsonl(path: str) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def cli_command(scale: str, device: str, root: str, capture: str = None):
    """(argv, config, cuts) of the CLI phase's command: a fresh ``root``
    holding a copy of the scale's config with its cuts, the out dir
    ``root/out``, four stages on the synthetic scene or on ``capture``."""
    import shutil

    from d3human_tpu_torch.config import load_config

    s = CLI_SCALES[scale]
    here = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    src_path = os.path.join(here, s["config"])
    with open(src_path) as fh:
        cfg_json = json.load(fh)
    cuts = []
    for sec, vals in s["cuts"].items():
        cfg_json.setdefault(sec, {}).update(vals)
        cuts += [(sec, k) for k in vals]
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg_json, fh, indent=1)
    cfg, src_cfg = load_config(cfg_path), load_config(src_path)
    cuts = {f"{sec}.{k}": [getattr(getattr(c, sec), k)
                           for c in (src_cfg, cfg)] for sec, k in cuts}
    data = (["--synthetic", "--synthetic-frames", str(s["frames"])]
            if capture is None else
            ["--trainset_path", capture, "--folder_name", CAPTURE_FOLDER])
    argv = ["--config", cfg_path, "--out-dir", os.path.join(root, "out"),
            *data, "--stages", "split_smpl,init,split,seq", "--iters-scale",
            str(s["iters_scale"]), "--device", device]
    return argv, cfg, cuts


def phase_cli(scale: str, device: str, root: str,
              capture: str = None) -> dict:
    """The port's CLI in this process, ``main(argv)`` with ``--stages
    split_smpl,init,split,seq --device <device>`` on a copy of the scale's
    config with its cuts, into a fresh out dir under ``root``: on the
    synthetic scene (``--synthetic``, phase ``cli``), then once more with
    ``--resume``, which must run no step, reuse the host surgery's outputs
    and keep PARITY.json's entries; or, with ``capture`` (the root of a
    layout that ``phase_capture_export`` wrote), on that capture (phase
    ``capture_cli``). Returns what it emits (the first run's kernel
    launches and calls among it), the out dir and the first run's kernel
    inputs by call site (``recording_kernel_inputs``)."""
    from d3human_tpu_torch.utils import io as mesh_io

    s = CLI_SCALES[scale]
    name = "cli" if capture is None else "capture_cli"
    cuda = device == "cuda"
    argv, cfg, cuts = cli_command(scale, device, root, capture)
    out_dir = argv[argv.index("--out-dir") + 1]

    def n(x):
        return max(2, int(x * s["iters_scale"]))

    n_seq = min(s["frames"], cfg.stages.seq_max_frames)
    expect = {"split_smpl": n(cfg.stages.split_smpl_epoch),
              "init": n(cfg.stages.init_epoch),
              "split": n(cfg.stages.split_epoch),
              "seq": n(cfg.stages.seq_iters_first)
              + (n_seq - 1) * n(cfg.stages.seq_iters_rest)}
    with instrumented_cli(device) as (cli, rec), recording_kernel_inputs(
            tag=lambda: rec["current"] or "between stages") as inputs:
        sync(device)
        reset_peak(device)
        reset_counts()
        t0 = time.perf_counter()
        text = run_cli(cli, argv, s["parity_samples"])
        sync(device)
        total_s = time.perf_counter() - t0
        counts = read_counts()
        phase_peak = max(rec["peak_gib"] or 0.0, peak_gib(device) or 0.0) \
            if cuda else None
        stages = {}
        for stage, r in rec["stages"].items():
            steps, data_ms = _ms(device, r["steps"]), _ms(device, r["gt"])
            st = dict(
                iterations=len(steps), seconds=r.get("seconds"),
                mean_step_ms=sum(steps) / len(steps) if steps else None,
                step_ms=steps, peak_mem_gib=r.get("peak_mem_gib"),
                launches=r.get("launches"), calls=r.get("calls"))
            mean_data = sum(data_ms) / len(data_ms) if data_ms else None
            if capture is None:
                st.update(gt_renders=len(data_ms), mean_gt_ms=mean_data)
            else:
                dec, host = _ms("cpu", r["decode"]), _ms("cpu", r["gt_host"])
                st.update(data_reads=len(data_ms), mean_data_ms=mean_data,
                          mean_data_host_ms=(
                              sum(host) / len(host) if host else None),
                          decodes=len(dec), mean_decode_ms=(
                              sum(dec) / len(dec) if dec else None))
            stages[stage] = st
        first_steps = rec["steps"]
    check("[done]" in text.split("\n"), f"{name}: no [done] line")
    for stage, want in expect.items():
        got = stages.get(stage, {}).get("iterations")
        check(got == want, f"{name}: {stage} ran {got} steps, expected "
              f"{want}")
    join = os.path.join
    for stage, d in CLI_STAGE_DIRS.items():
        lines = _read_jsonl(join(out_dir, d, "loss_log", "scalars.jsonl"))
        tot = [ln for ln in lines if "total" in ln]
        check(len(tot) > 0, f"{name}: {stage} logged no loss")
        for ln in lines:
            for k, v in ln.items():
                if "loss" in k or k == "total":
                    check(math.isfinite(v), f"{name}: {stage} {k} = {v}")
        stages[stage]["losses_logged"] = tot[-1]
        stages[stage]["validation"] = [
            {k: v for k, v in ln.items() if k.startswith("val_")}
            for ln in lines if any(k.startswith("val_") for k in ln)]
    for stage in ("split_smpl", "init", "split"):
        fm = join(out_dir, CLI_STAGE_DIRS[stage], "validate",
                  "final_metrics.json")
        check(os.path.exists(fm), f"{name}: no {fm}")
    halves = {}
    for half in ("cloth", "body"):
        _, f = mesh_io.load_obj(join(out_dir, CLI_STAGE_DIRS["split"],
                                     f"split_{half}_imesh_final.obj"))
        halves[half] = len(f)
        check(len(f) > 0, f"{name}: the split stage's {half} half is empty")
    for f in range(n_seq):
        for path in (join(out_dir, "seq", "delta", f"{f}.npz"),
                     join(out_dir, "seq", f"fine_all_{f}.ply")):
            check(os.path.exists(path), f"{name}: no {path}")
    with open(join(out_dir, "PARITY.json")) as fh:
        parity = json.load(fh)["stages"]
    want_parity = {"split_smpl", "init", "split"} | (
        {"seq_template_frame0", "seq"} if capture is None else set())
    check(set(parity) >= want_parity,
          f"{name}: PARITY.json holds {sorted(parity)}")
    launches = {k: v for k, v in counts.items() if k != "calls"}
    for k in ("first_k_indices", "coo_scatter_add", "resolve_tiles"):
        check(not cuda or launches[k] > 0,
              f"{name}: {k} never launched ({launches})")
    # every counted call went through a recorded call site (a resolve call
    # is one launch)
    recorded = {k: sum(r["calls"] for r in v.values())
                for k, v in inputs.items()}
    counted = dict(first_k_indices=counts["calls"]["first_k_indices"],
                   coo_scatter_add=counts["calls"]["coo_scatter_add"],
                   resolve_tiles=launches["resolve_tiles"]
                   + launches["resolve_tiles_peel"])
    check(not cuda or recorded == counted,
          f"{name}: recorded calls {recorded}, counted {counted}")
    # the copies of the recorded calls stay on the device during the run,
    # inside the peaks above
    recorded_gib = sum(
        x.numel() * x.element_size() for v in inputs.values()
        for r in v.values() for x in _tensors(r["args"])) / 2 ** 30
    calls = counts.pop("calls")
    out = dict(scale=scale, config=s["config"], cuts=cuts,
               frames=s["frames"], iters_scale=s["iters_scale"],
               argv=argv, seconds=total_s, steps=first_steps,
               peak_mem_gib=phase_peak, recorded_inputs_gib=recorded_gib,
               recorded_calls=recorded, stages=stages, launches=counts,
               calls=calls, split_faces=halves, parity=parity)
    if capture is None:
        out["resume"] = resume_cli(argv, s["parity_samples"], parity, device)
    emit(name, **out)
    return dict(out, out_dir=out_dir, inputs=inputs)


def resume_cli(argv: list, parity_samples, parity: dict, device) -> dict:
    """The CLI's command again with ``--resume`` after a finished run: no
    training step, the close hole and the merge reused, every PARITY.json
    entry kept."""
    with instrumented_cli(device) as (cli, rec):
        reset_counts()
        t0 = time.perf_counter()
        text_r = run_cli(cli, argv + ["--resume"], parity_samples)
        resume_s = time.perf_counter() - t0
        resume_counts = read_counts()
        check(rec["steps"] == 0,
              f"cli --resume: {rec['steps']} training steps ran")
    lines_r = text_r.split("\n")
    check("[done]" in lines_r, "cli --resume: no [done] line")
    for what in ("[close_hole] resume: reusing", "[merge] resume: reusing"):
        check(any(ln.startswith(what) for ln in lines_r),
              f"cli --resume: no '{what}' line")
    out_dir = argv[argv.index("--out-dir") + 1]
    with open(os.path.join(out_dir, "PARITY.json")) as fh:
        parity_r = json.load(fh)["stages"]
    check(set(parity_r) >= set(parity),
          f"cli --resume: PARITY.json {sorted(parity_r)}")
    return dict(seconds=resume_s, steps=0, parity_kept=sorted(parity_r),
                launches={k: v for k, v in resume_counts.items()
                          if k != "calls"})


CLI_CUT_DIR = "d3human_tpu_torch/build/smoke_cli_cut"


def _numbers(x, prefix: str = "") -> dict:
    """The numbers of a JSON tree by path."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            out.update(_numbers(v, f"{prefix}/{k}"))
        return out
    if isinstance(x, list):
        out = {}
        for i, v in enumerate(x):
            out.update(_numbers(v, f"{prefix}/{i}"))
        return out
    return {prefix: x} if isinstance(x, (int, float)) else {}


def _npz(path: str) -> dict:
    import numpy as np

    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def compare_runs(want_dir: str, got_dir: str) -> dict:
    """Two CLI out dirs bit for bit: every stage's newest state checkpoint
    (every leaf), every seq delta npz and fine_all ply, every number of
    PARITY.json's stages. Returns the counts compared."""
    import numpy as np

    from d3human_tpu_torch.train.checkpoint import latest_checkpoint

    join = os.path.join
    n = dict(checkpoints=0, leaves=0, deltas=0, plys=0, parity_numbers=0)
    for stage, d in CLI_STAGE_DIRS.items():
        cw = latest_checkpoint(join(want_dir, d, "ckp"))
        cg = latest_checkpoint(join(got_dir, d, "ckp"))
        check((cw is None) == (cg is None) and (cw is None or os.path.basename(
            cw) == os.path.basename(cg)),
            f"cli_cut: {stage} checkpoints {cw} / {cg}")
        if cw is None:
            continue
        a, b = _npz(cw), _npz(cg)
        check(a.keys() == b.keys(), f"cli_cut: {stage} checkpoint keys")
        bad = [k for k in a if not np.array_equal(a[k], b[k])]
        check(not bad, f"cli_cut: {stage} leaves differ: {bad[:4]}")
        n["checkpoints"] += 1
        n["leaves"] += len(a)
    seq_w, seq_g = join(want_dir, "seq"), join(got_dir, "seq")
    deltas = sorted(os.listdir(join(seq_w, "delta")))
    check(deltas == sorted(os.listdir(join(seq_g, "delta"))),
          "cli_cut: the seq deltas' files differ")
    for fn in deltas:
        a, b = _npz(join(seq_w, "delta", fn)), _npz(join(seq_g, "delta", fn))
        check(a.keys() == b.keys() and all(
            np.array_equal(a[k], b[k]) for k in a),
            f"cli_cut: delta/{fn} differs")
        n["deltas"] += 1
    plys = sorted(f for f in os.listdir(seq_w) if f.startswith("fine_all_"))
    for fn in plys:
        with open(join(seq_w, fn), "rb") as fa, open(join(seq_g, fn),
                                                      "rb") as fb:
            check(fa.read() == fb.read(), f"cli_cut: {fn} differs")
        n["plys"] += 1
    pw, pg = (_numbers(json.load(open(join(d, "PARITY.json")))["stages"])
              for d in (want_dir, got_dir))
    check(pw == pg, "cli_cut: PARITY.json differs: " + str(
        sorted(k for k in set(pw) | set(pg) if pw.get(k) != pg.get(k))[:6]))
    n["parity_numbers"] = len(pw)
    check(n["deltas"] > 0 and n["plys"] > 0 and n["checkpoints"] >= 3,
          f"cli_cut: too little compared: {n}")
    return n


def phase_cli_cut(scale: str, device: str, cli: dict, root: str) -> dict:
    """The ``cli`` phase's command again into a fresh out dir under
    ``root``, cut inside the split stage (``CutRun`` from the
    instrumented step counter as the split's second step starts, as the
    CPU test cuts a run), then the same command with ``--resume``: every
    final checkpoint leaf, seq delta and ply and every PARITY.json number
    bit for bit the straight run's (``cli['out_dir']``). Seconds and steps
    of both parts."""
    import shutil

    s = CLI_SCALES[scale]
    st = cli["stages"]
    stop_at = st["split_smpl"]["iterations"] + st["init"]["iterations"] + 1
    shutil.rmtree(root, ignore_errors=True)
    out_dir = os.path.join(root, "out")
    argv = list(cli["argv"])
    argv[argv.index("--out-dir") + 1] = out_dir
    with instrumented_cli(device, stop_at=stop_at) as (mod, rec):
        t0 = time.perf_counter()
        try:
            run_cli(mod, argv, s["parity_samples"])
            cut = False
        except CutRun:
            cut = True
        cut_s = time.perf_counter() - t0
        cut_steps = rec["steps"]
    check(cut and cut_steps == stop_at,
          f"cli_cut: the run was not cut at step {stop_at} ({cut_steps})")
    with instrumented_cli(device) as (mod, rec):
        t0 = time.perf_counter()
        text = run_cli(mod, argv + ["--resume"], s["parity_samples"])
        resume_s = time.perf_counter() - t0
        resume_steps = rec["steps"]
    check("[done]" in text.split("\n"), "cli_cut: no [done] line")
    check(cut_steps + resume_steps >= cli["steps"],
          f"cli_cut: {cut_steps} + {resume_steps} steps for the straight "
          f"run's {cli['steps']}")
    compared = compare_runs(cli["out_dir"], out_dir)
    out = dict(cut_at_step=stop_at, cut_in_stage="split", cut_s=cut_s,
               resume_s=resume_s, resume_steps=resume_steps,
               straight_steps=cli["steps"], bitwise=True, **compared)
    emit("cli_cut", **out)
    return out


SCORER_TOL = 1e-6        # score_seq_partial against the CLI's own entry


def phase_scorers(scale: str, device: str, cli: dict, root: str) -> dict:
    """The two parity scorers on the ``cli`` phase's out dir:
    ``eval_parity`` over the run's frames as views (every stage has its
    entry, the union's IoUs and the ceilings in (0, 1], the halves' IoUs
    in [0, 1], PSNR and Chamfers finite);
    ``score_seq_partial`` in place (its Chamfers within SCORER_TOL of the
    CLI's own seq entry; PARITY.json is put back as it was), then on a
    copy of the seq meshes less the last frame's (``n_frames`` one less,
    the ``partial`` marker). Seconds of each; the kernels' launches and
    calls of the three runs."""
    import shutil

    import d3human_tpu_torch.train_d3h as cli_mod
    from d3human_tpu_torch.scripts import eval_parity, score_seq_partial

    s = CLI_SCALES[scale]
    frames, out_dir = s["frames"], cli["out_dir"]
    cfg_path = cli["argv"][cli["argv"].index("--config") + 1]
    common = ["--config", cfg_path, "--n-frames", str(frames), "--device",
              device]
    saved = cli_mod.PARITY_SAMPLES
    if s["parity_samples"] is not None:
        cli_mod.PARITY_SAMPLES = s["parity_samples"]
    ppath = os.path.join(out_dir, "PARITY.json")
    with open(ppath, "rb") as fh:
        parity_bytes = fh.read()
    sync(device)
    reset_counts()
    try:
        t0 = time.perf_counter()
        check(eval_parity.main(common + [
            "--out-dir", out_dir, "--stages", "split_smpl,init,split,seq",
            "--n-views", str(frames)]) == 0, "scorers: eval_parity failed")
        sync(device)
        ev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        check(score_seq_partial.main(common + ["--out-dir", out_dir]) == 0,
              "scorers: score_seq_partial failed")
        sync(device)
        sp_s = time.perf_counter() - t0
        with open(ppath) as fh:
            full = json.load(fh)["stages"]["seq"]
        part_dir = os.path.join(root, "out")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(os.path.join(part_dir, "seq"))
        for f in range(frames - 1):
            shutil.copy(os.path.join(out_dir, "seq", f"fine_all_{f}.ply"),
                        os.path.join(part_dir, "seq"))
        check(score_seq_partial.main(common + ["--out-dir", part_dir]) == 0,
              "scorers: score_seq_partial on the partial copy failed")
        with open(os.path.join(part_dir, "PARITY.json")) as fh:
            part = json.load(fh)["stages"]["seq"]
    finally:
        cli_mod.PARITY_SAMPLES = saved
        with open(ppath, "wb") as fh:
            fh.write(parity_bytes)
    counts = read_counts()
    calls = counts.pop("calls")
    with open(os.path.join(out_dir, "PARITY_MULTIVIEW.json")) as fh:
        mv = json.load(fh)
    for stage in ("split_smpl", "init", "split", "seq"):
        check(stage in mv, f"scorers: eval_parity has no {stage} entry")
    for stage in ("split_smpl", "init", "split"):
        e = mv[stage]
        check(e["n_views"] == frames, f"scorers: {stage} {e['n_views']} "
              "views")
        # the union's IoUs and the halves' ceilings are positive; a half's
        # own IoU may be 0 (the 2-iteration split_smpl's body half renders
        # nothing: body_iou 0.0 in the run's own PARITY.json)
        halves = ("body", "cloth") if stage != "init" else ()
        for k in ["iou_mean", "iou_min"] + [f"{p}_iou_ceiling"
                                             for p in halves]:
            check(0 < e[k] <= 1, f"scorers: {stage} {k} = {e.get(k)}")
        for k in [f"{p}_iou_mean" for p in halves]:
            check(0 <= e[k] <= 1, f"scorers: {stage} {k} = {e.get(k)}")
        check(math.isfinite(e["psnr_mean"]), f"scorers: {stage} psnr")
        for k, v in e.items():
            if k.startswith("chamfer"):
                check(math.isfinite(v), f"scorers: {stage} {k} = {v}")
    check(mv["seq"]["n_frames"] == frames
          and math.isfinite(mv["seq"]["chamfer_all_mean"]),
          f"scorers: eval_parity's seq entry {mv['seq']}")
    want = cli["parity"]["seq"]
    rel = {k: abs(full[k] - want[k]) / max(abs(want[k]), 1e-30)
           for k in ("chamfer_per_frame_mean", "chamfer_per_frame_max")}
    check(max(rel.values()) <= SCORER_TOL and full["n_frames"] == frames,
          f"scorers: score_seq_partial {full} against the CLI's {want}")
    check(part["n_frames"] == frames - 1 and "partial" in part,
          f"scorers: score_seq_partial on {frames - 1} frames: {part}")
    out = dict(eval_parity_s=ev_s, score_seq_partial_s=sp_s,
               multiview=mv, seq_partial=dict(full=full, rel_to_cli=rel,
                                              partial=part),
               launches=counts, calls=calls)
    emit("scorers", **out)
    return out


# ---------------------------------------------------------------- captures

# the layout that the port's exporter writes at each scale: the CLI
# scale's training resolution and frame count, the body model of the
# capture_data phase's SMPL-X check (vertices and faces; 55 joints,
# shapedirs [V, 3, 400], posedirs [V, 3, 486] at every scale)
BAKE_SCALES = {"full": dict(res=2048, check_res=256),
               "tiny": dict(res=64, check_res=32)}


def phase_bake(scale: str, device: str, cli_root: str) -> dict:
    """The port's bake entry point (``d3human_tpu_torch.scripts.
    bake_texture``) on a CLI run (``phase_cli``'s root): its init
    checkpoint and ``init/watertight_imesh_final.obj`` under the run's
    config, at BAKE_SCALES' resolution with ``--atlas lscm`` and with
    ``--atlas grid``. Per atlas: faces, charts, the unwrap's seconds, the
    bake's seconds on the device, then the UV rasterization and the
    texture lookups of that bake timed alone, the files written; the
    device's ``render_uv`` at ``check_res`` against the CPU's on the same
    atlas and checkpoint (masks exact, kd and ks abs 1e-5)."""
    import torch

    from d3human_tpu_torch.ops.rasterizer import (
        barycentrics, interpolate, rasterize_bruteforce,
    )
    from d3human_tpu_torch.render.texture2d import UV_ROWS, render_uv
    from d3human_tpu_torch.scripts import bake_texture

    b = BAKE_SCALES[scale]
    run = os.path.join(cli_root, "out")
    out = {}
    for atlas in ("lscm", "grid"):
        dst = os.path.join(cli_root, f"bake_{atlas}")
        args = bake_texture.parse_args([
            "--run", run, "--stage", "init", "--mesh",
            os.path.join(run, "init", "watertight_imesh_final.obj"),
            "--res", str(b["res"]), "--atlas", atlas, "--out", dst,
            "--config", os.path.join(cli_root, "config.json"),
            "--device", device])
        (r, total_s) = timed(device, lambda: bake_texture.bake(args))
        files = {f: os.path.getsize(os.path.join(dst, f))
                 for f in ("texture_kd.png", "texture_ks.png",
                           "mesh_uv.obj")}
        mask = r["mask"]
        check(0.05 < float(mask.mean()) < 1.0,
              f"bake {atlas}: {float(mask.mean())} of the texels covered")
        check(bool(torch.isfinite(r["kd"]).all()
                   and torch.isfinite(r["ks"]).all()),
              f"bake {atlas}: non-finite texels")
        # the bake's two parts alone: the UV rasterization, the lookups
        dev = mask.device
        res = (b["res"], b["res"])
        vt = torch.as_tensor(r["v_tex"], dtype=torch.float32, device=dev)
        ti = torch.as_tensor(r["t_tex_idx"], dtype=torch.int64, device=dev)
        tp = torch.as_tensor(r["faces"], dtype=torch.int64, device=dev)
        vp = torch.as_tensor(r["verts"], dtype=torch.float32, device=dev)
        uv_clip = torch.cat([vt * 2 - 1, torch.zeros_like(vt[:, :1]),
                             torch.ones_like(vt[:, :1])], -1)
        fv = torch.ones((ti.shape[0],), dtype=torch.bool, device=dev)
        with torch.no_grad():
            rast, raster_s = timed(device, lambda: rasterize_bruteforce(
                uv_clip, ti, fv, res, pixel_chunk=UV_ROWS * res[1]))
            bary, _ = barycentrics(uv_clip, ti, rast, res)
            pos = interpolate(vp, bary, tp, rast)
            tex, mat = r["tex"], r["material"]
            _, lookup_s = timed(device, lambda: tex.sample(mat, pos))
        check(torch.equal(rast.tri_id > 0, mask[..., 0] > 0),
              f"bake {atlas}: the timed rasterization differs")
        # the device's render_uv against the CPU's at check_res
        small = (b["check_res"], b["check_res"])
        cpu_mat = tree_map(lambda t: t.cpu(), mat)
        cpu_tex = bake_texture.texture_module(args.config, "cpu")
        with torch.no_grad():
            got = render_uv(vp, vt, ti, tp, small, tex, mat)
            want = render_uv(vp.cpu(), vt.cpu(), ti.cpu(), tp.cpu(), small,
                             cpu_tex, cpu_mat)
        check(torch.equal(got[0].cpu(), want[0]),
              f"bake {atlas}: masks differ from the CPU's")
        err = max(float((g.cpu() - w).abs().max())
                  for g, w in zip(got[1:], want[1:]))
        check(err <= 1e-5, f"bake {atlas}: {err} from the CPU's bake")
        out[atlas] = dict(
            res=b["res"], faces=len(r["faces"]), verts=len(r["verts"]),
            uv_verts=len(r["v_tex"]), charts=r["n_charts"],
            unwrap_s=r["unwrap_s"], bake_s=r["bake_s"], total_s=total_s,
            uv_raster_s=raster_s, texture_lookup_ms=lookup_s * 1e3,
            covered=float(mask.mean()), files=files,
            check_res=b["check_res"], max_abs_err_vs_cpu=err)
    emit("bake", checkpoint=os.path.relpath(r["checkpoint"], cli_root),
         **out)
    return out


CAPTURE_SCALES = {"full": dict(res=1080, body=(10475, 20908)),
                  "tiny": dict(res=48, body=(400, 796))}
CAPTURE_DIR = "d3human_tpu_torch/build/smoke_capture"
CAPTURE_FOLDER = "neutral-synth"
# the layout's round trip against the scene (the JAX package's bounds,
# tests/test_reference_layout.py:56-68): mvp, mask IoU (above), rgb,
# normals
ROUND_TRIP = dict(mvp=1e-4, iou=0.99, rgb=0.02, normal=0.05)
BODY_RTOL = 1e-5         # the body model on the card against the CPU


def encode_png(path: str, img, filter_type=0, palette=None, trns=None,
               interlace: int = 0) -> None:
    """A PNG of ``img`` with the scanline filter ``filter_type`` (0 None,
    1 Sub, 2 Up, 3 Average, 4 Paeth; or one type per row): uint8 [H, W]
    grey, [H, W, 2|3|4] grey + alpha, RGB, RGBA, or uint16 (16-bit).
    With ``palette`` [n, 3] ``img`` holds its indices (colour type 3),
    with ``trns`` the palette's alphas. ``interlace`` is only written to
    the header (a reader must refuse it)."""
    import struct
    import zlib

    import numpy as np

    a = np.asarray(img)
    depth = 16 if a.dtype == np.uint16 else 8
    H, W = a.shape[:2]
    C = 1 if a.ndim == 2 else a.shape[2]
    color = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[C]
    raw = np.ascontiguousarray(a.astype(">u2" if depth == 16 else np.uint8))
    x = raw.reshape(H, -1).view(np.uint8).astype(np.int16)
    bpp = C * depth // 8
    left, up, upleft = (np.zeros_like(x) for _ in range(3))
    left[:, bpp:], up[1:] = x[:, :-bpp], x[:-1]
    upleft[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    ft = np.broadcast_to(np.asarray(filter_type, np.uint8), (H,))
    rows = ((x - preds[ft, np.arange(H)]) % 256).astype(np.uint8)
    data = np.concatenate([ft[:, None], rows], 1).tobytes()

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color,
                                           0, 0, interlace)))
        if palette is not None:
            f.write(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
        if trns is not None:
            f.write(chunk(b"tRNS", np.asarray(trns, np.uint8).tobytes()))
        f.write(chunk(b"IDAT", zlib.compress(data, 6)))
        f.write(chunk(b"IEND", b""))


def write_smplx_npz(path: str, V: int, F: int, seed: int = 0) -> None:
    """A seeded body model in the official SMPLX_<GENDER>.npz layout at
    ``V`` vertices and ``F`` faces: 55 joints (SMPL-X's tree, the root's
    parent stored as uint32 -1), shapedirs [V, 3, 400] (300 shape and 100
    expression columns), posedirs [V, 3, 486], a normalised regressor and
    normalised skinning weights. Random values: it checks the widths, not
    a body."""
    import numpy as np

    from d3human_tpu_torch.models.smplx.model import SMPLX_PARENTS

    rng = np.random.default_rng(seed)
    J = len(SMPLX_PARENTS)
    reg = rng.random((J, V), np.float32) ** 8
    w = rng.random((V, J), np.float32) ** 8
    kintree = np.stack([np.asarray(SMPLX_PARENTS, np.int64), np.arange(J)])
    kintree[0, 0] = 2 ** 32 - 1
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path,
             v_template=(rng.normal(size=(V, 3)) * 0.3).astype(np.float32),
             shapedirs=(rng.normal(size=(V, 3, 400)) * 1e-3).astype(
                 np.float32),
             posedirs=(rng.normal(size=(V, 3, (J - 1) * 9)) * 1e-3).astype(
                 np.float32),
             J_regressor=reg / reg.sum(1, keepdims=True),
             weights=w / w.sum(1, keepdims=True),
             f=rng.integers(0, V, (F, 3)).astype(np.int64),
             kintree_table=kintree)


def phase_capture_export(scale: str, device: str, root: str) -> dict:
    """The port's exporter (``python -m
    d3human_tpu_torch.scripts.export_reference_layout``) writes the
    synthetic scene at the scale's resolution and the CLI scale's frame
    count into a fresh ``root``: seconds, files and bytes."""
    import shutil

    from d3human_tpu_torch.scripts import export_reference_layout as exporter

    s = CAPTURE_SCALES[scale]
    frames = CLI_SCALES[scale]["frames"]
    shutil.rmtree(root, ignore_errors=True)
    rc, secs = timed(device, lambda: exporter.main(
        ["--out", root, "--folder", CAPTURE_FOLDER, "--res", str(s["res"]),
         "--frames", str(frames), "--device", device]))
    check(rc == 0, f"capture_export: exit {rc}")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]
    png = [f for f in files if f.endswith(".png")]
    check(len(png) == 5 * frames, f"capture_export: {len(png)} PNG files")
    out = dict(resolution=[s["res"], s["res"]], frames=frames, seconds=secs,
               files=len(files), bytes=sum(map(os.path.getsize, files)),
               png_bytes=sum(map(os.path.getsize, png)))
    emit("capture_export", **out)
    return out


def _host_ms(fn, reps: int = 1):
    """(fn(), mean host milliseconds over ``reps`` calls)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return out, (time.perf_counter() - t0) * 1e3 / reps


def _dev_ms(device, fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn``: CUDA events on the card, the host's
    clock on the CPU."""
    if device == "cuda":
        return cuda_ms(fn, reps=reps, warm=1)
    fn()
    return _host_ms(fn, reps)[1]


def write_source_2x(ds, dst: str, seed: int = 0) -> None:
    """A one-frame layout under ``dst`` at twice ``ds``'s resolution, the
    size its cameras.npz records: each file of ``ds``'s first frame with
    every pixel p turned into the 2x2 block [[p + e, p - e], [p - e, p +
    e]], e drawn in [0, 2] and kept within [0, 255], so that the exact 2x
    resize gives p back; written with the five scanline filters in turn
    by row; ``smplx/`` copied, key.list 0 1."""
    import shutil

    import numpy as np

    from d3human_tpu_torch.data.dataset import _FOLDERS
    from d3human_tpu_torch.utils.io import load_image

    rng = np.random.default_rng(seed)
    shutil.rmtree(dst, ignore_errors=True)
    idx = ds.key_frame[0]
    for k, d in _FOLDERS.items():
        a = load_image(ds.lists[k][idx]).astype(np.int16)
        e = np.minimum(rng.integers(0, 3, a.shape), np.minimum(a, 255 - a))
        up, de = (np.repeat(np.repeat(x, 2, 0), 2, 1) for x in (a, e))
        yy, xx = np.indices(up.shape[:2])
        sign = np.where((yy + xx) % 2 == 0, 1, -1).astype(np.int16)
        if up.ndim == 3:
            sign = sign[..., None]
        os.makedirs(os.path.join(dst, d))
        encode_png(os.path.join(dst, d, "000000.png"),
                   (up + de * sign).astype(np.uint8),
                   np.arange(up.shape[0]) % 5)
    shutil.copytree(os.path.join(ds.base_dir, "smplx"),
                    os.path.join(dst, "smplx"))
    with open(os.path.join(dst, "key.list"), "w") as fh:
        fh.write("0\n1\n")


def phase_capture_data(scale: str, device: str, root: str) -> dict:
    """The capture data path on the layout under ``root``:
    - ``FrameDataset`` at the scale's resolution: every frame's host decode
      and device preprocessing (ms), and its targets against the synthetic
      scene's ``frame_target`` under the exporter's camera within
      ``ROUND_TRIP``;
    - frame 0 at the camera's own size (twice the resolution, as real
      captures are; ``write_source_2x``): host decode and device
      preprocessing (ms), its targets equal to frame 0's bit for bit (the
      exact 2x resize), and ``_resize`` on the device equal to the CPU's
      on each of its images and on a random image of that size;
    - ``load_image`` on frame 0's RGB image re-encoded with each scanline
      filter (0-4, and one per row in turn): exactly the image (ms a
      decode);
    - the frame cache: built from the dataset, read through the native
      library, within 2e-3 of ``frame_target`` (``GT_TOL``; ms a frame,
      MiB);
    - a seeded body model in the official SMPL-X npz layout at the scale's
      size (SMPL-X's 10,475 vertices and 20,908 faces at full scale):
      ``load_smplx_npz`` and ``forward`` on the device against the CPU
      within rel ``BODY_RTOL``, and the time of the canonical weight
      transfer of the CLI scale's lattice to its vertices."""
    import dataclasses

    import numpy as np
    import torch

    from d3human_tpu_torch.config import load_config
    from d3human_tpu_torch.data.dataset import FrameDataset, _resize
    from d3human_tpu_torch.data.frame_cache import (
        FrameCacheReader, build_cache,
    )
    from d3human_tpu_torch.data.synthetic import make_scene
    from d3human_tpu_torch.models.smplx.deformer import SMPLXDeformer
    from d3human_tpu_torch.models.smplx.model import load_smplx_npz
    from d3human_tpu_torch.ops.tet_grid import make_tet_grid
    from d3human_tpu_torch.render.camera import camera_matrices
    from d3human_tpu_torch.utils.io import load_image

    s = CAPTURE_SCALES[scale]
    res = (s["res"], s["res"])
    frames = CLI_SCALES[scale]["frames"]
    base = os.path.join(root, CAPTURE_FOLDER)
    ds = FrameDataset(base, res, device=device)
    check(ds.n_images == frames, f"capture_data: {ds.n_images} frames")

    # ---- the dataset against the scene under the exporter's camera
    cam = np.load(os.path.join(base, "smplx", "cameras.npz"))
    mv, mvp, campos = camera_matrices(cam["intrinsic"], cam["extrinsic"],
                                      int(cam["height"]), int(cam["width"]))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    scene = dataclasses.replace(
        make_scene(res, n_frames=frames, device=device), mv=t(mv),
        mvp=t(mvp), campos=t(campos))
    ds.decode(ds.key_frame[frames - 1])          # builds the native reader
    decode_ms, prep_ms = [], []
    err = dict(mvp=0.0, rgb=0.0, normal=0.0)
    iou = {}
    for i in range(frames):
        imgs, ms = _host_ms(lambda: ds.decode(ds.key_frame[i]))
        decode_ms.append(ms)
        got, secs = timed(device, lambda: ds.preprocess(imgs))
        prep_ms.append(secs * 1e3)
        want = scene.frame_target(i)
        err["mvp"] = max(err["mvp"], float((ds.mvp - want["mvp"]).abs().max()))
        err["rgb"] = max(err["rgb"], float(
            (got["all_img"][..., :3] - want["all_img"][..., :3]).abs().max()))
        err["normal"] = max(err["normal"], float(
            (got["all_normal"] - want["all_normal"]).abs().max()))
        for k in ("all_img", "body_img", "cloth_img"):
            a, b = got[k][..., 3] > 0.5, want[k][..., 3] > 0.5
            r = float((a & b).sum()) / max(float((a | b).sum()), 1.0)
            iou[k] = min(iou.get(k, 1.0), r)
    for k in ("mvp", "rgb", "normal"):
        check(err[k] < ROUND_TRIP[k],
              f"capture_data: {k} {err[k]} from the scene")
    check(min(iou.values()) > ROUND_TRIP["iou"],
          f"capture_data: mask IoU {iou}")

    # ---- frame 0 at the camera's own size, resized 2x on the device
    src2 = os.path.join(root, "source_2x")
    write_source_2x(ds, src2)
    ds2 = FrameDataset(src2, res, device=device)
    ds2.decode(0)                                   # warm-up
    decode2_ms, prep2_ms = [], []
    for _ in range(3):
        ds2._last = (None, None)
        imgs2, ms = _host_ms(lambda: ds2.decode(0))
        decode2_ms.append(ms)
        got2, secs = timed(device, lambda: ds2.preprocess(imgs2))
        prep2_ms.append(secs * 1e3)
    want2 = ds.preprocess(ds.decode(ds.key_frame[0]))
    for k, v in want2.items():
        check(torch.equal(got2[k], v),
              f"capture_data: {k} of the 2x source is not frame 0's")
    h2, w2 = imgs2["rgb"].shape[:2]
    check((h2, w2) == (2 * res[0], 2 * res[1]),
          f"capture_data: the 2x source is {h2} x {w2}")
    noise = np.random.default_rng(2).integers(0, 256, (h2, w2, 3), np.uint8)
    for k, a in [*imgs2.items(), ("random", noise)]:
        x = torch.from_numpy(a)
        check(torch.equal(_resize(x.to(device), res).cpu(), _resize(x, res)),
              f"capture_data: _resize of the 2x {k} on {device} is not the "
              "CPU's")

    # ---- the PNG reader on every scanline filter
    src_png = ds.lists["rgb"][0]
    rgb0 = load_image(src_png)
    filters = {}
    for name, ft in [(str(f), f) for f in range(5)] + [
            ("per row", np.arange(res[0]) % 5)]:
        path = os.path.join(root, f"filter_{name.replace(' ', '_')}.png")
        encode_png(path, rgb0, ft)
        back, ms = _host_ms(lambda: load_image(path), reps=3)
        check(back.dtype == np.uint8 and np.array_equal(back, rgb0),
              f"capture_data: load_image on filter {name} is not the image")
        filters[name] = dict(decode_ms=ms, bytes=os.path.getsize(path))

    # ---- the frame cache
    path = os.path.join(root, "frames.bin")
    _, build_s = timed(device, lambda: build_cache(ds, path))
    reader = FrameCacheReader(path, res, device=device)
    cache_ms, cache_err = [], {}
    for i in range(frames):
        got, secs = timed(device, lambda: reader.frame(i))
        cache_ms.append(secs * 1e3)
        want = ds.frame_target(i)
        for k, v in got.items():
            cache_err[k] = max(cache_err.get(k, 0.0),
                               float((v - want[k]).abs().max()))
    reader.close()
    check(max(cache_err.values()) <= GT_TOL,
          f"capture_data: the frame cache against frame_target {cache_err}")

    # ---- the body model at SMPL-X's published widths
    V, F = s["body"]
    npz_dir = os.path.join(root, "smplx_size")
    write_smplx_npz(os.path.join(npz_dir, "SMPLX_NEUTRAL.npz"), V, F)
    (m_dev, load_s), m_cpu = timed(device, lambda: load_smplx_npz(
        npz_dir, "neutral", device=device)), load_smplx_npz(
        npz_dir, "neutral", device="cpu")
    rng = np.random.default_rng(1)
    B = 2
    args = {k: rng.normal(size=(B, d)).astype(np.float32) * 0.2 for k, d in (
        ("root_pose", 3), ("body_pose", 63), ("jaw_pose", 3),
        ("leye_pose", 3), ("reye_pose", 3), ("lhand_pose", 45),
        ("rhand_pose", 45), ("transl", 3))}
    args["betas"] = rng.normal(size=(B, m_cpu.num_betas)).astype(np.float32)
    args["expression"] = rng.normal(size=(B, m_cpu.num_expr)).astype(
        np.float32)

    def fwd(m, dev):
        with torch.no_grad():
            return m.forward(**{k: torch.as_tensor(v, device=dev)
                                for k, v in args.items()})

    body_err = {}
    for name, a, b in zip(("verts", "joints", "A"), fwd(m_dev, device),
                          fwd(m_cpu, "cpu")):
        rel = float((a.cpu() - b).abs().max() / b.abs().max())
        check(rel <= BODY_RTOL, f"capture_data: forward {name} rel {rel}")
        body_err[name] = rel
    forward_ms = _dev_ms(device, lambda: fwd(m_dev, device))
    # the canonical weight transfer of the CLI's lattice (its crop of the
    # synthetic template, as the CLI builds it) to the model's vertices
    cli_cfg = load_config(CLI_SCALES[scale]["config"])
    g = cli_cfg.geometry
    for sec, vals in CLI_SCALES[scale]["cuts"].items():
        if sec == "geometry":
            g = dataclasses.replace(g, **vals)
    cb = make_scene((8, 8), 1, device="cpu").canon.vs_template[0].numpy()
    grid = make_tet_grid(res=g.grid_res, y_offset=g.grid_y_offset,
                         scale=g.grid_scale,
                         crop_box=(tuple(cb.min(0) - g.grid_crop),
                                   tuple(cb.max(0) + g.grid_crop)),
                         device=device)
    deformer = SMPLXDeformer(m_dev)
    canon = deformer.initialize(torch.zeros((1, m_dev.num_betas),
                                            device=device))
    with torch.no_grad():
        w = deformer.interpolate_weights(canon, grid.verts)
        transfer_ms = _dev_ms(device, lambda: deformer.interpolate_weights(
            canon, grid.verts))
    check(tuple(w.shape) == (grid.n_verts, m_dev.num_joints)
          and bool(torch.isfinite(w).all()),
          f"capture_data: weight transfer {tuple(w.shape)}")

    out = dict(
        resolution=list(res), frames=frames,
        decode_ms=decode_ms, mean_decode_ms=sum(decode_ms) / frames,
        preprocess_ms=prep_ms, mean_preprocess_ms=sum(prep_ms) / frames,
        round_trip=dict(max_abs_err=err, min_mask_iou=iou,
                        bounds=ROUND_TRIP),
        source_2x=dict(
            resolution=[h2, w2], png_bytes=sum(
                os.path.getsize(ds2.lists[k][0]) for k in imgs2),
            upload_mib=sum(a.nbytes for a in imgs2.values()) / 2 ** 20,
            decode_ms=decode2_ms, mean_decode_ms=sum(decode2_ms) / 3,
            preprocess_ms=prep2_ms, mean_preprocess_ms=sum(prep2_ms) / 3,
            targets_equal_frame0=True, resize_equal_cpu=True),
        png_filters=dict(source=os.path.relpath(src_png, root),
                         exact=True, by_filter=filters),
        frame_cache=dict(build_s=build_s, frame_ms=cache_ms,
                         mean_frame_ms=sum(cache_ms) / frames,
                         mib=os.path.getsize(path) / 2 ** 20,
                         max_abs_err=cache_err, tolerance=f"abs {GT_TOL}"),
        body_model=dict(verts=m_dev.num_verts, faces=int(F),
                        joints=m_dev.num_joints,
                        shapedirs=list(m_dev.shapedirs.shape),
                        posedirs=list(m_dev.posedirs.shape), load_s=load_s,
                        forward_ms=forward_ms, rel_err=body_err,
                        rtol=BODY_RTOL, lattice_verts=grid.n_verts,
                        weight_transfer_ms=transfer_ms))
    emit("capture_data", **out)
    return out


# ---------------------------------------------------------------- parallel

PAR_FRAMES = 2           # frames of the parallel_seq phase
PAR_ITERS = 3            # iterations a frame in parallel_seq
PAR_SEED = 5             # the runner's seed (and the oracle's)
DP_BATCH = 2             # examples of a DP step
PAR_DIR = "d3human_tpu_torch/build/smoke_parallel"
PAR_TOL = 1e-6           # rel-L2 where a result is not bit for bit
DP_TOL = 1e-5            # the DP step's update against its serial oracle


def init_world1(device: str, root: str) -> bool:
    """A process group of one (NCCL for the card, gloo for the CPU) on a
    file store under ``root``, unless a group is up; True if it made one."""
    import datetime

    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    os.makedirs(root, exist_ok=True)
    store = os.path.join(root, "store_world1")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method="file://" + store, rank=0, world_size=1,
        timeout=datetime.timedelta(minutes=10))
    # NCCL builds its communicator at the first collective: here, not
    # inside a timed phase
    dist.all_reduce(torch.zeros(1, device=device))
    sync(device)
    return True


def par_targets(sc: dict) -> list:
    """One target a frame: the scene's view at frame_idx 0, 1, ..."""
    return [dict(sc["target"], frame_idx=f) for f in range(PAR_FRAMES)]


def no_warmup(cfg):
    """``cfg`` with warmup_iter 0, so that a fresh optimizer's first step
    moves the parameters."""
    return dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, warmup_iter=0))


def clone_tree(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms while active (warn only), as a
    cross-check: the port's paths hold no op that PyTorch lists as
    nondeterministic, so a run under this mode must equal the default
    mode's bit for bit, and no op may warn (cuBLAS needs
    CUBLAS_WORKSPACE_CONFIG, which ``main`` sets). Yields a list that
    receives, on exit, the first line of each warning about an op without
    a deterministic version."""
    import warnings

    import torch

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    seen = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield seen
        finally:
            torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
            seen.extend(sorted({str(w.message).split("\n")[0][:200]
                                for w in caught
                                if "deterministic" in str(w.message)}))


def compare_trees(got, want) -> tuple:
    """(bit for bit, the largest per-leaf rel-L2, that leaf) of two
    parameter trees."""
    import torch

    from d3human_tpu_torch.train.optim import named_leaves

    g, w = dict(named_leaves(got)), dict(named_leaves(want))
    check(set(g) == set(w), "parameter trees differ in their leaves")
    same, worst, where = True, 0.0, None
    for k in w:
        a, b = g[k].detach().cpu(), w[k].detach().cpu()
        if not torch.equal(a, b):
            same = False
            if rel_l2(a, b) >= worst:
                worst, where = rel_l2(a, b), k
    return same, worst, where


DET_STEPS = 3            # steps a stage in the determinism phase
DET_SEED = 11            # the determinism phase's generators


def det_steps(sc: dict, stage: str, device: str) -> dict:
    """DET_STEPS steps of ``stage`` from a fresh state on a copy of the
    scene's parameters (no warm-up in the schedule, so the first step
    moves them), the generator seeded DET_SEED: the state, the losses as
    floats and each step's ms (CUDA events on the card)."""
    import torch

    from d3human_tpu_torch.train.step import init_state, make_train_step

    cfg, raster_opts = stage_cfg(sc, stage)
    cfg = no_warmup(cfg)
    state = init_state(stage, clone_tree(sc["params"]), cfg)
    step_fn = make_train_step(stage, sc["model"], sc["tex"], sc["perceptual"],
                              sc["perc_params"], cfg, raster_opts,
                              template=sc.get("seq_template"))
    gen = torch.Generator(device=device).manual_seed(DET_SEED)
    sync(device)
    metrics, ms = [], []
    for _ in range(DET_STEPS):
        t0 = time.perf_counter()
        state, m = step_fn(state, sc["target"], gen)
        sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    return dict(state=state, losses=[scalars(m) for m in metrics], ms=ms)


def same_run(a: dict, b: dict) -> tuple:
    """(bit for bit, what differs) of two ``det_steps`` results: every
    parameter, every Adam moment and count, every loss."""
    import torch

    same, worst, where = compare_trees(a["state"].params, b["state"].params)
    diff = [] if same else [f"params rel-L2 {worst} ({where})"]
    oa, ob = a["state"].opt, b["state"].opt
    for name in ("mu", "nu"):
        ma, mb = getattr(oa, name), getattr(ob, name)
        bad = sorted(k for k in set(ma) | set(mb)
                     if k not in ma or k not in mb
                     or not torch.equal(ma[k], mb[k]))
        if bad:
            diff.append(f"Adam {name}: {bad[:3]}")
    if oa.count != ob.count:
        diff.append(f"Adam count {oa.count} != {ob.count}")
    if a["losses"] != b["losses"]:
        diff.append("losses")
    return not diff, diff


def phase_determinism(sc: dict, device: str = "cuda") -> dict:
    """DET_STEPS init, split and seq steps from copies of the scene's
    parameters, twice in PyTorch's default mode with the same generators,
    then once more under ``deterministic()``: every parameter, Adam moment
    and loss bit for bit across the three, and no op warned under the
    deterministic mode; then one validation half (cloth) twice with the
    same generator, every buffer bit for bit. Step ms in both modes."""
    import torch

    out = {}
    for stage in ("init", "split", "seq"):
        runs = [det_steps(sc, stage, device) for _ in range(2)]
        with deterministic() as nondet:
            runs.append(det_steps(sc, stage, device))
        for i, other in ((1, "second default run"),
                         (2, "deterministic() run")):
            same, diff = same_run(runs[0], runs[i])
            check(same, f"determinism {stage}: the {other} differs from "
                  f"the first: {diff}")
        check(not nondet, f"determinism {stage}: ops without a "
              f"deterministic version: {nondet}")
        for ln in runs[0]["losses"]:
            check(all(math.isfinite(v) for v in ln.values()),
                  f"determinism {stage}: a loss is not finite")
        out[stage] = dict(steps=DET_STEPS, bitwise=True,
                          nondeterministic_ops=nondet,
                          default_ms=runs[0]["ms"] + runs[1]["ms"],
                          deterministic_ms=runs[2]["ms"],
                          total=[ln["total"] for ln in runs[0]["losses"]])
        del runs
    bufs = [_tensors(validation_render(sc, 1.0, torch.Generator(
        device=device).manual_seed(DET_SEED))[1]) for _ in range(2)]
    differ = [i for i, (a, b) in enumerate(zip(*bufs))
              if not torch.equal(a, b)]
    check(not differ and len(bufs[0]) > 0,
          f"determinism validate: buffers {differ} of the render differ")
    out["validate"] = dict(buffers=len(bufs[0]), bitwise=True)
    emit("determinism", **out)
    return out


def merge_recorded(*inputs) -> dict:
    """Kernel inputs recorded on several runs as one record: calls summed
    by site, each site's biggest call kept."""
    out = {}
    for inp in inputs:
        for kernel, sites in inp.items():
            for site, s in sites.items():
                o = out.setdefault(kernel, {}).get(site)
                if o is None:
                    out[kernel][site] = dict(s)
                    continue
                o["calls"] += s["calls"]
                if s["size"] > o["size"]:
                    o["size"], o["args"] = s["size"], s["args"]
    return out


def check_path_counts(phase: str, counts: dict, calls: dict,
                      per_call: dict, n: int) -> None:
    """On the card: first_k, the resolve and the scan called
    ``per_call[k] * n`` times, the scatter launched, no resolve with a
    floor."""
    from d3human_tpu_torch.ops import compaction, scan

    check(counts["coo_scatter_add"] > 0, f"{phase}: the scatter never "
          "launched")
    check(counts["resolve_tiles_peel"] == 0,
          f"{phase}: a training step launched the resolve with a floor")
    for k, per in per_call.items():
        check(calls[k] == per * n, f"{phase}: {k} called {calls[k]} times, "
              f"expected {per * n}")
    check(counts["first_k_indices"]
          == compaction.LAUNCHES * calls["first_k_indices"]
          and counts["resolve_tiles"] == calls["resolve_tiles"]
          and counts["inclusive_scan"]
          == scan.LAUNCHES * calls["inclusive_scan"],
          f"{phase}: launches {counts} for calls {calls}")


def phase_parallel_seq(sc: dict, device: str = "cuda") -> dict:
    """The frame-parallel seq runner (``make_parallel_seq_runner``) on a
    process group of one, PAR_FRAMES frames x PAR_ITERS iterations of the
    scene's seq template (no warm-up in the schedule): a timed run, kernel
    counts reset just before and read just after, the calls recorded by
    site; then, under ``deterministic()``, the runner again and a serial
    loop of ``make_train_step("seq")`` a frame from the same shared
    parameters with a fresh optimizer and the same generators: each
    frame's parameters and losses bit for bit (a rel-L2 within PAR_TOL and
    the ops without a deterministic version are reported). The frames
    differ. The timed run, in PyTorch's default mode, is bit for bit the
    deterministic one (no op of the path adds in a varying order). Wall
    seconds, ms an iteration a frame, peak memory, launches and calls."""
    import torch

    from d3human_tpu_torch.parallel.frames import make_parallel_seq_runner
    from d3human_tpu_torch.parallel.mesh import make_frame_mesh
    from d3human_tpu_torch.train.optim import named_leaves
    from d3human_tpu_torch.train.stages import iteration_generator
    from d3human_tpu_torch.train.step import init_state, make_train_step

    cfg = no_warmup(sc["seq_cfg"])
    args = (sc["model"], sc["tex"], sc["perceptual"], sc["perc_params"])
    targets = par_targets(sc)
    shared = clone_tree(sc["params"])
    mesh = make_frame_mesh(device=device)
    launch, _ = make_parallel_seq_runner(
        *args, sc["seq_template"], cfg, PAR_FRAMES, PAR_ITERS, mesh=mesh,
        raster_opts=sc["raster_opts"])
    sync(device)
    reset_peak(device)
    reset_counts()
    with recording_kernel_inputs(tag=lambda: "parallel_seq") as inputs:
        (timed_frames, timed_totals), wall = timed(device, lambda: launch(
            shared, targets, PAR_SEED))
    counts = read_counts()
    peak = peak_gib(device)
    calls = counts.pop("calls")
    if device == "cuda":
        check_path_counts("parallel_seq", counts, calls, STEP_CALLS["seq"],
                          PAR_FRAMES * PAR_ITERS)
    check(bool(torch.isfinite(timed_totals).all()),
          "parallel_seq: a loss is not finite")
    a, b = (dict(named_leaves(timed_frames[f])) for f in (0, 1))
    moved = [k for k in a if "nonrigid" in k and not torch.equal(a[k], b[k])]
    check(len(moved) > 0, "parallel_seq: the frames' parameters are equal")
    step_fn = make_train_step("seq", *args, cfg, sc["raster_opts"],
                              template=sc["seq_template"])
    same, worst, where, totals_same = True, 0.0, None, True
    with deterministic() as nondet:
        per_frame, totals = launch(shared, targets, PAR_SEED)
        for f in range(PAR_FRAMES):
            state = init_state("seq", clone_tree(shared), cfg)
            want = []
            for it in range(PAR_ITERS):
                state, m = step_fn(state, targets[f], iteration_generator(
                    PAR_SEED, f * 100000 + it, device))
                want.append(float(m["total"]))
            s, w, k = compare_trees(per_frame[f], state.params)
            if w >= worst:
                worst, where = w, k
            same = same and s
            got = totals[f].tolist()
            totals_same = totals_same and got == want
            worst = max(worst, max(abs(x - y) / abs(y)
                                   for x, y in zip(got, want)))
    # rel-L2 within PAR_TOL with a named nondeterministic op is reported,
    # and fails all the same: the runner is bit for bit the serial loops
    check(same and totals_same,
          f"parallel_seq: the runner against the serial steps: rel "
          f"{worst} ({where}, within PAR_TOL: {worst <= PAR_TOL}); ops "
          f"without a deterministic version: {nondet}")
    timed_same, timed_vs_det, timed_where = True, 0.0, None
    for f in range(PAR_FRAMES):
        s_f, w_f, k_f = compare_trees(timed_frames[f], per_frame[f])
        timed_same = timed_same and s_f
        if w_f >= timed_vs_det:
            timed_vs_det, timed_where = w_f, k_f
    timed_same = timed_same and torch.equal(timed_totals, totals)
    check(timed_same, f"parallel_seq: the timed run (default mode) is not "
          f"bit for bit the deterministic one: rel-L2 {timed_vs_det} "
          f"({timed_where})")
    out = dict(frames=PAR_FRAMES, iters=PAR_ITERS,
               faces=int(sc["seq_template"].f.shape[0]),
               world=mesh.world, group=mesh.group is not None,
               wall_s=wall, ms_per_iter_per_frame=wall * 1e3 / (
                   PAR_FRAMES * PAR_ITERS),
               peak_mem_gib=peak, bitwise=same and totals_same,
               max_rel_err=worst, worst_leaf=where,
               nondeterministic_ops=nondet,
               timed_vs_deterministic=dict(bitwise=timed_same,
                                           rel_l2=timed_vs_det,
                                           leaf=timed_where),
               totals=timed_totals.tolist(), frames_differ_in=len(moved),
               launches=counts, calls=calls)
    emit("parallel_seq", **out)
    return dict(out, inputs=inputs)


def phase_dp_step(sc: dict, device: str = "cuda") -> dict:
    """``make_dp_train_step`` of the init and the split stage on a process
    group of one at the scene's width, DP_BATCH examples (frame_idx 0, 1
    of the scene's view, each with its own injected draws) at the stage
    state's step, no warm-up in the schedule: a timed DP step a stage,
    kernel counts reset before the first and read after the second, the
    calls recorded by site; then, under ``deterministic()``, the DP step
    again and the serial oracle (a ``loss_and_grads`` an example, their
    mean, one step of the DP step's own optimizer: geometry clip 1.0,
    unscaled lr_pos): the update within DP_TOL rel-L2 a leaf. ms a DP step
    (host clock between two device synchronisations), peak memory, the
    metrics stacked [DP_BATCH]."""
    import torch

    from d3human_tpu_torch.parallel.frames import make_dp_train_step
    from d3human_tpu_torch.parallel.mesh import make_data_mesh
    from d3human_tpu_torch.train.optim import named_leaves
    from d3human_tpu_torch.train.step import (
        TrainState, _post_step, loss_and_grads,
    )

    args = (sc["model"], sc["tex"], sc["perceptual"], sc["perc_params"])
    targets = par_targets(sc)[:DP_BATCH]
    mesh = make_data_mesh(device=device)
    report, recorded = {}, []
    reset_counts()
    for stage in ("init", "split"):
        cfg = no_warmup(sc["cfg"])
        it = sc[STATE_KEY[stage]].step
        dp_step, opt_factory, _, _ = make_dp_train_step(
            stage, *args, cfg, raster_opts=sc["raster_opts"], mesh=mesh)
        draws = [tick_draws(cfg, stage, seed=20 + i)
                 for i in range(DP_BATCH)]
        before = clone_tree(sc["params"])

        def fresh():
            params = clone_tree(before)
            return TrainState(params=params, opt=opt_factory(params),
                              step=it)

        state = fresh()
        reset_peak(device)
        c0 = read_counts()
        with recording_kernel_inputs(tag=lambda: f"dp {stage}") as inputs:
            (state, metrics), dp_s = timed(device, lambda: dp_step(
                state, targets, draws))
        c1 = read_counts()
        recorded.append(inputs)
        peak = peak_gib(device)
        tot = metrics["total"]
        check(tuple(tot.shape) == (DP_BATCH,)
              and bool(torch.isfinite(tot).all()),
              f"dp_step {stage}: totals {tot}")
        with deterministic() as nondet:
            state, _ = dp_step(fresh(), targets, draws)
            oracle = clone_tree(before)
            opt = opt_factory(oracle)
            grads = [loss_and_grads(stage, *args, oracle, targets[i], it,
                                    cfg, opt.trainable_paths(),
                                    sc["raster_opts"], draws=draws[i])[1]
                     for i in range(DP_BATCH)]
            mean = {}
            for p in grads[0]:
                gs = [g[p] for g in grads if g[p] is not None]
                mean[p] = sum(gs) / DP_BATCH if gs else None
            opt.step(oracle, mean)
            _post_step(oracle, sc["model"])
        b0 = dict(named_leaves(before))
        got = {k: v - b0[k] for k, v in named_leaves(state.params)
               if v.is_floating_point()}
        want = {k: v - b0[k] for k, v in named_leaves(oracle)
                if v.is_floating_point()}
        moved = [k for k in want if float(want[k].abs().max()) > 0]
        check(len(moved) > 0, f"dp_step {stage}: the oracle moved nothing")
        worst, where = max((rel_l2(got[k], want[k]), k) for k in moved)
        where = where if worst > 0 else None
        same = all(torch.equal(got[k], want[k]) for k in want)
        check(worst <= DP_TOL, f"dp_step {stage}: update rel-L2 {worst} "
              f"({where}); ops without a deterministic version: {nondet}")
        report[stage] = dict(step=it, ms=dp_s * 1e3,
                             peak_mem_gib=peak, bitwise=same,
                             update_rel_l2=worst, worst_leaf=where,
                             nondeterministic_ops=nondet,
                             leaves_moved=len(moved), totals=tot.tolist(),
                             launches={k: c1[k] - c0[k] for k in c1
                                       if k != "calls"},
                             calls={k: c1["calls"][k] - c0["calls"][k]
                                    for k in c1["calls"]})
    # the two timed steps' counts alone (the deterministic reruns and the
    # oracles launch too)
    counts, calls = ({k: sum(report[st][what][k] for st in report)
                      for k in report["init"][what]}
                     for what in ("launches", "calls"))
    if device == "cuda":
        check_path_counts("dp_step", counts, calls, {
            k: STEP_CALLS["init"][k] + STEP_CALLS["split"][k]
            for k in STEP_CALLS["init"]}, DP_BATCH)
    out = dict(batch=DP_BATCH, world=mesh.world, tolerance=DP_TOL,
               launches=counts, calls=calls, **report)
    emit("dp_step", **out)
    return dict(out, inputs=merge_recorded(*recorded))


def world2_scene(device: str) -> dict:
    """The tiny scene with its seq template on ``device``, with the
    parameters fitted on the CPU (as ``small_scenes``)."""
    cpu = build_scene("tiny", "cpu", 50)
    if device == "cpu":
        sc = cpu
    else:
        sc = build_scene("tiny", device, 0)
        sc["params"] = tree_map(lambda t: t.to(device), cpu["params"])
    add_seq(sc, "tiny")
    return sc


def parallel_job(sc: dict) -> dict:
    """The runner (PAR_FRAMES frames x 2 iterations from PAR_SEED) and a
    DP step of the init stage (one example a frame target, injected draws)
    on the scene, as ``parallel_jobs`` takes them."""
    cfg = no_warmup(sc["cfg"])
    return dict(
        common={k: sc[k] for k in ("model", "tex", "perceptual",
                                   "perc_params", "params", "raster_opts")},
        runner=dict(cfg=no_warmup(sc["seq_cfg"]), template=sc["seq_template"],
                    targets=par_targets(sc), seed=PAR_SEED, n_iters=2),
        dp=dict(stage="init", cfg=cfg, targets=par_targets(sc),
                draws=[tick_draws(cfg, "init", seed=30 + i)
                       for i in range(PAR_FRAMES)], step=0))


def parallel_jobs(job: dict) -> dict:
    """The parts of ``job`` in this process, on its process group if it
    has one: ``runner`` (the frame-parallel seq runner), ``dp`` (one DP
    step from a fresh optimizer), ``driver`` (``run_seq_stage_parallel``
    into its ``save_path``); a part's model, texture, perceptual loss,
    parameters and raster options are its own or ``common``'s. Returns the runner's per-frame parameters
    and totals and the DP step's parameters and metrics, on the CPU (a
    frame this rank does not hold is None)."""
    import torch

    from d3human_tpu_torch.parallel.frames import (
        make_dp_train_step, make_parallel_seq_runner,
    )
    from d3human_tpu_torch.train.stages import run_seq_stage_parallel
    from d3human_tpu_torch.train.step import TrainState

    def part(name):
        d = {**job.get("common", {}), **job[name]}
        return d, (d["model"], d["tex"], d["perceptual"], d["perc_params"])

    def cpu(tree):
        return None if tree is None else tree_map(
            lambda t: t.detach().cpu(), tree)

    out = {}
    if "runner" in job:
        r, args = part("runner")
        launch, _ = make_parallel_seq_runner(
            *args, r["template"], r["cfg"], len(r["targets"]), r["n_iters"],
            raster_opts=r["raster_opts"])
        per_frame, totals = launch(r["params"], r["targets"], r["seed"])
        out["runner"] = ([cpu(p) for p in per_frame], totals)
    if "dp" in job:
        d, args = part("dp")
        dp_step, opt_factory, _, _ = make_dp_train_step(
            d["stage"], *args, d["cfg"], raster_opts=d["raster_opts"])
        params = clone_tree(d["params"])
        state = TrainState(params=params, opt=opt_factory(params),
                           step=d["step"])
        state, metrics = dp_step(state, d["targets"], d["draws"])
        out["dp"] = (cpu(state.params), {k: v.cpu()
                                         for k, v in metrics.items()})
    if "driver" in job:
        d, args = part("driver")
        run_seq_stage_parallel(
            d["params"], d["template"], d["targets"].__getitem__,
            len(d["targets"]), d["cfg"], d["save_path"], d["seed"], *args,
            raster_opts=d["raster_opts"])
    return out


def parallel_worker(rank: int, world: int, store: str, job_path: str,
                    out_dir: str) -> None:
    """One rank of ``spawn_parallel``: a gloo group on the file store, the
    job's parts under ``deterministic()``, its result in
    ``rank<r>.pt``."""
    import datetime

    import torch
    import torch.distributed as dist

    from d3human_tpu_torch.utils.backend import configure_backends

    torch.set_num_threads(1)
    configure_backends()
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=5))
    try:
        job = torch.load(job_path, weights_only=False)
        with deterministic():
            out = parallel_jobs(job)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_parallel(world: int, job: dict, root: str,
                   timeout_s: float = 600.0) -> list:
    """``parallel_jobs(job)`` in ``world`` spawned processes (gloo, a file
    store under ``root``, so that concurrent runs cannot collide); a rank
    that raises, or a run past ``timeout_s``, raises here, and every
    process is gone on return. Returns each rank's result."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    job_path = os.path.join(root, "job.pt")
    torch.save(job, job_path)
    ctx = mp.start_processes(
        parallel_worker, args=(world, os.path.join(root, "store"), job_path,
                               root),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn_parallel: {world} ranks still "
                                   f"running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def phase_parallel_world2(sc: dict, device: str, root: str,
                          scale: str) -> dict:
    """The runner and the DP step of ``parallel_job`` on the scene (of
    ``scale``) in this process (world 1) and in two spawned processes
    sharing the device (gloo; one frame and one example a rank), all
    under ``deterministic()``: rank 0's per-frame parameters and totals,
    and every rank's DP parameters and metrics, against world 1, bit for
    bit or within PAR_TOL rel-L2."""
    import torch

    job = parallel_job(sc)
    t0 = time.perf_counter()
    with deterministic():
        w1 = parallel_jobs(job)
    w1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = spawn_parallel(2, job, root)
    w2_s = time.perf_counter() - t0
    same, worst = True, 0.0
    for f, want in enumerate(w1["runner"][0]):
        s, w, _ = compare_trees(ranks[0]["runner"][0][f], want)
        same, worst = same and s, max(worst, w)
    for r in ranks:
        check(torch.equal(r["runner"][1], ranks[0]["runner"][1]),
              "parallel_world2: the ranks' totals differ")
        s, w, _ = compare_trees(r["dp"][0], w1["dp"][0])
        same, worst = same and s, max(worst, w)
        for k, v in w1["dp"][1].items():
            s = torch.equal(r["dp"][1][k], v)
            same = same and s
            if not s:
                worst = max(worst, rel_l2(r["dp"][1][k], v))
    t_same = torch.equal(ranks[0]["runner"][1], w1["runner"][1])
    if not t_same:
        worst = max(worst, rel_l2(ranks[0]["runner"][1], w1["runner"][1]))
    check(ranks[1]["runner"][0][0] is None,
          "parallel_world2: rank 1 holds frame 0")
    check(same and t_same or worst <= PAR_TOL,
          f"parallel_world2: world 2 against world 1: rel {worst}")
    out = dict(scale=scale, device=device, world=2, backend="gloo",
               frames=PAR_FRAMES, iters=2, dp_batch=PAR_FRAMES,
               bitwise=same and t_same, max_rel_err=worst,
               world1_s=w1_s, world2_s=w2_s)
    emit("parallel_world2", **out)
    return out


CLI_PAR_DIR = "d3human_tpu_torch/build/smoke_cli_parallel"


def phase_cli_parallel(scale: str, device: str, cli_root: str,
                       root: str) -> dict:
    """The port's CLI with ``--stages seq --seq-parallel`` and the cli
    phase's other arguments, in this process, on a copy of that phase's
    out dir whose seq/ is removed first: [done]; every frame's
    delta/<f>.npz with the serial run's keys, its offsets of the serial
    run's shape, fine_all_<f>.ply with the serial run's vertex and face
    counts (the template's), the loss_log at frame * 100000 + it every
    log_interval, all finite; the kernels launched."""
    import shutil

    import numpy as np

    from d3human_tpu_torch.config import load_config
    from d3human_tpu_torch.utils import io as mesh_io

    s = CLI_SCALES[scale]
    cfg_path = os.path.join(cli_root, "config.json")
    cfg = load_config(cfg_path)
    shutil.rmtree(root, ignore_errors=True)
    out_dir = os.path.join(root, "out")
    shutil.copytree(os.path.join(cli_root, "out"), out_dir)
    seq = os.path.join(out_dir, "seq")
    n_seq = min(s["frames"], cfg.stages.seq_max_frames)
    serial = {}
    for f in range(n_seq):
        with np.load(os.path.join(seq, "delta", f"{f}.npz")) as z:
            keys = sorted(z.files)
            shape = z["delta"].shape
        v, fc = mesh_io.read_ply(os.path.join(seq, f"fine_all_{f}.ply"))
        serial[f] = (keys, shape, len(v), len(fc))
    shutil.rmtree(seq)
    argv = ["--config", cfg_path, "--out-dir", out_dir, "--synthetic",
            "--synthetic-frames", str(s["frames"]), "--stages", "seq",
            "--seq-parallel", "--iters-scale", str(s["iters_scale"]),
            "--device", device]
    import d3human_tpu_torch.train_d3h as cli

    sync(device)
    reset_peak(device)
    reset_counts()
    t0 = time.perf_counter()
    text = run_cli(cli, argv, s["parity_samples"])
    sync(device)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    calls = counts.pop("calls")
    lines = text.split("\n")
    check("[done]" in lines, "cli_parallel: no [done] line")
    check(any(ln.startswith("[seq-par] done") for ln in lines),
          "cli_parallel: no [seq-par] done line")
    iters = max(2, int(cfg.stages.seq_iters_first * s["iters_scale"]))
    for f, (keys, shape, nv, nf) in serial.items():
        with np.load(os.path.join(seq, "delta", f"{f}.npz")) as z:
            check(sorted(z.files) == keys, f"cli_parallel: delta/{f}.npz "
                  f"holds {sorted(z.files)}, the serial run's {keys}")
            check(z["delta"].shape == shape
                  and bool(np.isfinite(z["delta"]).all()),
                  f"cli_parallel: delta/{f}.npz {z['delta'].shape}")
        v, fc = mesh_io.read_ply(os.path.join(seq, f"fine_all_{f}.ply"))
        check((len(v), len(fc)) == (nv, nf),
              f"cli_parallel: fine_all_{f}.ply {len(v)} verts {len(fc)} "
              f"faces, the serial run's {nv} / {nf}")
    logged = _read_jsonl(os.path.join(seq, "loss_log", "scalars.jsonl"))
    want = [f * 100000 + it for f in range(n_seq)
            for it in range(0, iters, cfg.stages.log_interval)]
    check([ln["step"] for ln in logged] == want,
          f"cli_parallel: loss_log steps {[ln['step'] for ln in logged]}")
    check(all(math.isfinite(ln["total"]) for ln in logged),
          "cli_parallel: a logged loss is not finite")
    for k in ("first_k_indices", "coo_scatter_add", "resolve_tiles"):
        check(device != "cuda" or counts[k] > 0,
              f"cli_parallel: {k} never launched ({counts})")
    with open(os.path.join(out_dir, "PARITY.json")) as fh:
        parity = json.load(fh)["stages"].get("seq", {})
    out = dict(scale=scale, argv=argv, seconds=seconds, frames=n_seq,
               iters=iters, peak_mem_gib=peak_gib(device),
               files=2 * n_seq + 1, parity=parity, launches=counts,
               calls=calls)
    emit("cli_parallel", **out)
    return out


# ---------------------------------------------------------------- ref_grid

REF_DIR = "d3human_tpu_torch/build/smoke_ref_grid"
REF_LOSS_TOL = 1e-5      # a step's losses, unstructured grid against lattice
REF_GRAD_TOL = 1e-4      # a step's gradients, rel-L2 a leaf
REF_POS_TOL = 1e-7       # positions after a reference-format file's round trip
REF_SEED = 13            # the generators of the ref_grid steps
# Adam steps fitting the uncropped lattice's SDF to the capsule: a quarter
# of SEED_STEPS, since a full-batch step there takes 3.2x the vertices;
# the fit's final loss is reported (pretrain_loss)
REF_SEED_STEPS = 100
# the steps a stage of the ref_grid comparison takes
REF_STEPS = (("init", INIT_STEPS), ("split", SPLIT_STEPS))


def on_grid(sc: dict, grid) -> dict:
    """The scene with its model on ``grid`` and fresh init and split states
    (no warm-up, so the first step moves the parameters) on a copy of its
    parameters."""
    from d3human_tpu_torch.models.geometry import GeometryModel
    from d3human_tpu_torch.train.step import init_state

    cfg, m = no_warmup(sc["cfg"]), sc["model"]
    params = clone_tree(sc["params"])
    return dict(sc, cfg=cfg, params=params,
                model=GeometryModel(cfg, grid, m.deformer, m.canon),
                state=init_state("init", params, cfg),
                split_state=init_state("split", params, cfg))


def grid_counts(sc: dict) -> dict:
    """The extraction's counts on the scene's parameters: crossing edges,
    sign-mixed tets, faces of the init mesh and of each split half, and
    the pixels the init mesh covers at the training resolution."""
    import torch

    from d3human_tpu_torch.ops.rasterizer import rasterize, xfm_points

    g, pose, model = sc["params"]["geometry"], sc["params"]["pose"], \
        sc["model"]
    with torch.no_grad():
        m = model.get_meshes(g, pose, 0)
        cloth, body = model.get_meshes_pair(g, pose, 0)
        rast = rasterize(xfm_points(m.verts_posed, sc["target"]["mvp"]),
                         m.mesh.faces, m.mesh.face_valid,
                         tuple(sc["cfg"].render.train_res),
                         **(sc["raster_opts"] or {}))
    return dict(n_cross=int(m.mesh.n_cross),
                n_valid_tets=int(m.mesh.n_valid_tets),
                faces=int(m.mesh.face_valid.sum()),
                cloth_faces=int(cloth.mesh.face_valid.sum()),
                body_faces=int(body.mesh.face_valid.sum()),
                covered_pixels=int((rast.tri_id > 0).sum()))


def check_capacity(where: str, m: dict, cfg) -> None:
    """A step's counts inside the static capacities: crossing edges and
    sign-mixed tets of each half, covered pixels and AA pairs."""
    g = cfg.geometry
    for k, v in m.items():
        if k.endswith("n_cross"):
            check(0 < v <= g.max_verts, f"{where}: {k} {v} of {g.max_verts}")
        elif k.endswith("n_valid_tets"):
            check(0 < v <= g.max_tets, f"{where}: {k} {v} of {g.max_tets}")
        elif k.endswith(("cap_cov", "cap_aa")):
            check(v <= 1.0, f"{where}: {k} {v}")


def ref_stepper(sc: dict, stage: str, grads: bool = True):
    """step() -> one training step of ``stage`` from the scene's state
    (the generator seeded REF_SEED once): the losses, with ``grads`` a copy
    of the gradients the optimizer was given, and the step's ms (host
    clock around synchronised work); counts checked inside the
    capacities."""
    import torch

    step_fn = stage_step_fn(sc, stage)
    dev = sc["model"].grid.verts.device
    gen = torch.Generator(device=dev).manual_seed(REF_SEED)
    given = []
    n = [0]

    def step():
        state = sc[STATE_KEY[stage]]
        opt_step = state.opt.step

        def recorded(params, g):
            if grads:
                given.append({k: v.detach().clone() for k, v in g.items()
                              if v is not None})
            opt_step(params, g)

        state.opt.step = recorded
        try:
            (state, m), s = timed(dev, lambda: step_fn(state, sc["target"],
                                                       gen))
        finally:
            del state.opt.step
        m = scalars(m)
        where = f"ref_grid {stage} {n[0]}"
        check_step_metrics(stage, m, where)
        check_capacity(where, m, sc["cfg"])
        n[0] += 1
        return dict(losses=m, ms=s * 1e3,
                    grads=given.pop() if grads else None)

    return step


def add_counts(launches: dict, calls: dict, counts: dict) -> None:
    """Adds ``read_counts()``'s launches and calls to the two totals."""
    for k, n in counts.items():
        if k != "calls":
            launches[k] = launches.get(k, 0) + n
            calls[k] = calls.get(k, 0) + counts["calls"][k]


def follow(dst, src) -> None:
    """``dst``'s training state set to ``src``'s: parameters, Adam moments
    and counts (in place where they exist)."""
    import torch

    from d3human_tpu_torch.train.optim import named_leaves

    with torch.no_grad():
        for (k, a), (j, b) in zip(named_leaves(dst.params),
                                  named_leaves(src.params)):
            check(k == j, f"follow: {k} != {j}")
            a.copy_(b)
    dst.opt.mu = {k: v.clone() for k, v in src.opt.mu.items()}
    dst.opt.nu = {k: v.clone() for k, v in src.opt.nu.items()}
    dst.opt.count, dst.step = src.opt.count, src.step


def compare_ref_step(where: str, w: dict, g: dict, worst: dict) -> None:
    """One step on the unstructured grid (``g``) against the same step on
    the lattice (``w``): the counters exactly equal, every loss within
    REF_LOSS_TOL, every gradient leaf within REF_GRAD_TOL rel-L2; the
    largest errors kept in ``worst``."""
    check(set(w["losses"]) == set(g["losses"]), f"{where}: keys differ")
    for k, a in w["losses"].items():
        b = g["losses"][k]
        if k.endswith(EXACT + ("cap_cov", "cap_aa")):
            check(a == b, f"{where}: {k} {b} != {a}")
        elif k == "total" or k.endswith("loss"):
            err = abs(b - a) / abs(a) if a else abs(b)
            check(err <= REF_LOSS_TOL, f"{where}: {k} {b} vs {a}")
            if err >= worst["loss"]:
                worst.update(loss=err, loss_key=k)
    check(set(w["grads"]) == set(g["grads"]),
          f"{where}: gradient leaves differ")
    for k, a in w["grads"].items():
        err = rel_l2(g["grads"][k], a) if bool(a.any()) else float(
            g["grads"][k].abs().max())
        check(err <= REF_GRAD_TOL, f"{where}: gradient {k} rel-L2 {err}")
        if err >= worst["grad"]:
            worst.update(grad=err, grad_leaf=k)


def check_endpoint_scatter(label: str, grid) -> dict:
    """On the card: the scatter at ``sdf_reg_loss``'s two endpoint-gather
    backwards on an unstructured grid (N = its edges, C = 1, its vertices
    as rows; a call site the recorder may file under a bigger gather's
    backward), on random rows, held to its plain version as in the kernels
    phase; timed beside ``index_add_``, not held to it (no hot row).
    {call: report}; on the CPU none."""
    import torch

    dev = grid.verts.device
    if dev.type != "cuda":
        return {}
    gen = torch.Generator(device=dev).manual_seed(5)
    e = grid.edges[: grid.n_edges]
    live = torch.ones((grid.n_edges,), dtype=torch.bool, device=dev)
    return {f"sdf_reg_loss endpoint {i} bwd": check_scatter(
        f"{label} sdf_reg_loss endpoint {i} bwd", e[:, i], live, 1,
        grid.n_verts, False, gen, faster=False) for i in (0, 1)}


@contextlib.contextmanager
def timed_unique_edges():
    """While active, the host seconds of each ``_unique_edges_generic``
    call (the sort-based unique edges of an unstructured grid) are
    appended to the yielded list."""
    from d3human_tpu_torch.ops import tet_grid

    fn, seconds = tet_grid._unique_edges_generic, []

    def timed_fn(tets):
        t0 = time.perf_counter()
        out = fn(tets)
        seconds.append(time.perf_counter() - t0)
        return out

    tet_grid._unique_edges_generic = timed_fn
    try:
        yield seconds
    finally:
        tet_grid._unique_edges_generic = fn


def reference_round_trip(lattice, path: str) -> tuple:
    """(the grid read back, its load seconds, unique-edge seconds, largest
    position error): ``lattice`` written as a reference-format npz at
    ``path`` and read through ``load_reference_tet_grid``; its tets the
    lattice's, positions within REF_POS_TOL."""
    import torch

    from d3human_tpu_torch.ops import tet_grid as tg

    dev = lattice.verts.device
    tg.save_reference_tet_grid(path, lattice.verts.cpu().numpy(),
                               lattice.tets.cpu().numpy())
    with timed_unique_edges() as unique_s:
        grid, load_s = timed(dev, lambda: tg.load_reference_tet_grid(
            path, device=dev))
    err = float((grid.verts - lattice.verts).abs().max())
    check(grid.dims is None and grid.vert_dims is None,
          "ref_grid: a reference-format grid with dims")
    check(torch.equal(grid.tets, lattice.tets),
          "ref_grid: the file's tets differ from the lattice's")
    check(err <= REF_POS_TOL, f"ref_grid: positions moved by {err}")
    return grid, load_s, unique_s[0], err


def phase_ref_grid(sc: dict, root: str) -> dict:
    """The scene's cropped lattice as an unstructured grid (its verts and
    tets, edges from the sort: only the edge order differs) against the
    lattice itself, on copies of the scene's parameters: the extraction's
    counts exactly equal, then INIT_STEPS init and SPLIT_STEPS split steps
    on each, every step from one state with one generator's draws, losses
    within REF_LOSS_TOL and gradients within REF_GRAD_TOL; the lattice's
    round trip through a
    reference-format file under ``root`` (edges equal to the in-memory
    grid's). The unstructured steps' kernel counts and calls are the
    path's; their kernel inputs are recorded by call site."""
    import torch

    from d3human_tpu_torch.ops import tet_grid as tg

    lattice = sc["model"].grid
    dev = lattice.verts.device
    with timed_unique_edges() as unique_s:
        grid = tg.unstructured(lattice)
    check(grid.n_edges == lattice.n_edges,
          f"ref_grid: {grid.n_edges} unique edges, the lattice has "
          f"{lattice.n_edges}")
    loaded, load_s, file_unique_s, pos_err = reference_round_trip(
        lattice, os.path.join(root, "cropped.npz"))
    check(torch.equal(loaded.edges, grid.edges)
          and torch.equal(loaded.tet_edges, grid.tet_edges),
          "ref_grid: the file's edges differ from the in-memory grid's")
    del loaded
    s_sc, u_sc = on_grid(sc, lattice), on_grid(sc, grid)
    counts = grid_counts(s_sc)
    got = grid_counts(u_sc)
    check(got == counts, f"ref_grid: counts {got} != the lattice's {counts}")
    check(all(v > 0 for v in counts.values()), f"ref_grid: counts {counts}")
    launches, calls, steps, recorded = {}, {}, {}, []
    for stage, n in REF_STEPS:
        lattice_step = ref_stepper(s_sc, stage)
        grid_step = ref_stepper(u_sc, stage)
        worst = dict(loss=0.0, loss_key=None, grad=0.0, grad_leaf=None)
        ms, lattice_ms, c, cl = [], [], {}, {}
        for i in range(n):
            w = lattice_step()
            # the unstructured step from the lattice step's starting state
            # (followed after each step), so that each step compares the
            # two grids and not Adam's amplification of last-bit
            # differences, which divides each gradient by its own size
            reset_counts()
            with recording_kernel_inputs() as seen:
                g = grid_step()
            sync(dev)
            add_counts(c, cl, read_counts())
            recorded.append(seen)
            compare_ref_step(f"ref_grid {stage} step {i}", w, g, worst)
            follow(u_sc[STATE_KEY[stage]], s_sc[STATE_KEY[stage]])
            ms.append(g["ms"])
            lattice_ms.append(w["ms"])
        if dev.type == "cuda":
            check_path_counts(f"ref_grid {stage}", c, cl, STEP_CALLS[stage],
                              n)
        add_counts(launches, calls, dict(c, calls=cl))
        steps[stage] = dict(worst, ms=ms, lattice_ms=lattice_ms,
                            losses=g["losses"])
    scatter = check_endpoint_scatter("ref_grid", grid)
    out = dict(part="cropped", grid=dict(
        n_verts=grid.n_verts, n_tets=grid.n_tets, n_edges=grid.n_edges,
        lattice_dims=lattice.dims, unique_edges_s=unique_s[0]),
        round_trip=dict(load_s=load_s, unique_edges_s=file_unique_s,
                        max_pos_err=pos_err, tolerance=REF_POS_TOL),
        counts=counts, steps=steps, endpoint_scatter=scatter,
        tolerance=dict(loss_rel=REF_LOSS_TOL, grad_rel_l2=REF_GRAD_TOL,
                       counts="exact"))
    emit("ref_grid", **out)
    return dict(out, launches=launches, calls=calls,
                inputs=merge_recorded(*recorded))


def phase_ref_grid_uncropped(scale: str, device: str, seed_steps: int,
                             root: str) -> dict:
    """The whole lattice, as the reference's own grid file holds it: the
    scene built with the crop off (its field seeded as ``build_scene``
    seeds it), written as a reference-format npz under ``root``, read back
    through ``load_reference_tet_grid`` (host seconds of the sort-based
    unique edges), then INIT_STEPS init steps and one split step on it:
    step ms, peak memory, the counts inside the capacities. Kernel counts
    reset just before the steps and read just after; the steps' kernel
    inputs are recorded by call site."""
    sc, scene_s = timed(device, lambda: build_scene(scale, device,
                                                    seed_steps, crop=False))
    grid, load_s, unique_s, pos_err = reference_round_trip(
        sc["model"].grid, os.path.join(root, "uncropped.npz"))
    rsc = on_grid(sc, grid)
    del sc
    gc.collect()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
    reset_peak(device)
    with recording_kernel_inputs() as inputs:
        reset_counts()
        step = ref_stepper(rsc, "init", grads=False)
        init = [step() for _ in range(INIT_STEPS)]
        split = [ref_stepper(rsc, "split", grads=False)()]
        sync(device)
        launches = read_counts()
    calls = launches.pop("calls")
    if device == "cuda":
        check_path_counts("ref_grid uncropped init + split", launches, calls,
                          {k: INIT_STEPS * n + STEP_CALLS["split"][k]
                           for k, n in STEP_CALLS["init"].items()}, 1)
    peak = peak_gib(device)
    scatter = check_endpoint_scatter("ref_grid_uncropped", grid)
    last = init[-1]["losses"]
    out = dict(part="uncropped", grid=dict(
        n_verts=grid.n_verts, n_tets=grid.n_tets, n_edges=grid.n_edges,
        load_s=load_s, unique_edges_s=unique_s, max_pos_err=pos_err),
        scene_s=scene_s, pretrain_loss=rsc["pretrain_loss"],
        init_ms=[r["ms"] for r in init], split_ms=[r["ms"] for r in split],
        peak_mem_gib=peak,
        counts={k: last[k] for k in ("n_cross", "n_valid_tets", "cap_cov")},
        split_counts={k: split[0]["losses"][k] for k in (
            "cloth_n_cross", "cloth_n_valid_tets", "body_n_cross",
            "body_n_valid_tets")},
        capacity=dict(max_verts=rsc["cfg"].geometry.max_verts,
                      max_tets=rsc["cfg"].geometry.max_tets),
        losses=last, split_losses=split[0]["losses"],
        endpoint_scatter=scatter)
    emit("ref_grid", **out)
    return dict(out, launches=launches, calls=calls, inputs=dict(inputs))


# ---------------------------------------------------------------- bench

BENCH_STAGES = ("init", "split", "seq")   # the runs of the bench phase
BENCH_SCALES = {
    # the JAX bench's full scale, default warm-up and timed steps
    "full": {},
    # a CPU-sized rehearsal: the small scale, a short seed, 1 + 2 steps and
    # no eikonal term (its 50,000-point double backward is most of a CPU
    # step)
    "small": {"BENCH_SDF_SEED_STEPS": "10", "BENCH_WARMUP": "1",
              "BENCH_ITERS": "2", "BENCH_NO_EIK": "1"},
}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
BENCH_MS_RATIO = 3.0     # a bench step against its stage's step phase
BENCH_TIMEOUT_S = 600.0


def bench_vars(scale: str, stage: str) -> dict:
    """The BENCH_* variables of the bench phase's run of ``stage``."""
    run = ({"BENCH_SCALE": f"seq:{scale}"} if stage == "seq" else
           {"BENCH_SCALE": scale, "BENCH_STAGE": stage})
    return {**BENCH_SCALES[scale], **run}


def run_bench(env: dict, device: str, root: str) -> dict:
    """``python -m d3human_tpu_torch.bench --device <device>`` in a
    subprocess from ``root``, ``env`` over this process's environment. A
    run that exits non-zero prints the tail of its stderr and fails; so
    does one without exactly one value line with the JAX bench's keys and
    a value > 0, or without its kernel line. A run past BENCH_TIMEOUT_S is
    killed and fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "d3human_tpu_torch.bench", "--device",
         device], cwd=root, env={**os.environ, **env}, capture_output=True,
        text=True, timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stderr[-6000:], file=sys.stderr, flush=True)
    check(proc.returncode == 0, f"bench {env}: exit code {proc.returncode}")
    out = proc.stdout.splitlines()
    check(len(out) == 1, f"bench {env}: {len(out)} lines on stdout")
    line = json.loads(out[0])
    check(set(line) == BENCH_KEYS, f"bench {env}: keys {sorted(line)}")
    check(line["value"] > 0, f"bench {env}: value {line['value']}")
    kern = [x for x in proc.stderr.splitlines() if x.startswith("# kernels ")]
    check(len(kern) == 1, f"bench {env}: {len(kern)} kernel lines")
    occ = re.search(r"peak occupancy ([0-9.]+)\)", line["metric"])
    return dict(line=line, ms_per_step=1e3 / line["value"],
                kernel_line=kern[0],
                kernels=json.loads(kern[0][len("# kernels "):]),
                seconds=seconds,
                peak_occupancy=float(occ.group(1)) if occ else None)


def check_bench_ms(stage: str, ms: float, step_ms: float) -> None:
    """The bench's ms a step within BENCH_MS_RATIO of ``step_ms``."""
    check(step_ms / BENCH_MS_RATIO <= ms <= step_ms * BENCH_MS_RATIO,
          f"bench {stage}: {ms:.2f} ms a step against {step_ms:.2f} ms of "
          f"its step phase")


def phase_bench(scale: str, device: str, root: str,
                step_ms: dict = None) -> dict:
    """The BENCH_STAGES' runs at ``scale`` on ``device`` from the checkout at
    ``root``. On the card each run's kernel calls a timed step are its
    stage's STEP_CALLS and its ms a step is held to ``step_ms[stage]``, the
    stage's step-phase mean in this script; on the CPU every count is 0.
    Returns each run and the launches and calls summed over the runs."""
    if device == "cuda":
        import torch

        free, total = torch.cuda.mem_get_info()
        emit("bench_memory", free_gib=free / 2 ** 30,
             total_gib=total / 2 ** 30)
    runs, launches, calls = {}, {}, {}
    for stage in BENCH_STAGES:
        r = run_bench(bench_vars(scale, stage), device, root)
        k, n = r["kernels"], r["kernels"]["iters"]
        if device == "cuda":
            check_path_counts(f"bench {stage}", k["launches"], k["calls"],
                              STEP_CALLS[stage], n)
            check_bench_ms(stage, r["ms_per_step"], step_ms[stage])
        else:
            check(not any(k["launches"].values()),
                  f"bench {stage}: kernel launches on the CPU")
        for acc, part in ((launches, k["launches"]), (calls, k["calls"])):
            for name, v in part.items():
                acc[name] = acc.get(name, 0) + v
        r.update(step_phase_ms=(step_ms or {}).get(stage),
                 calls_per_step={x: v / n for x, v in k["calls"].items()})
        emit("bench", stage=stage, **r)
        runs[stage] = r
    return dict(runs=runs, launches=launches, calls=calls)


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for y in x for t in _tensors(y)]
    return []


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # before the first cuBLAS handle: deterministic() needs it, and the
    # processes that spawn_parallel starts inherit it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import d3human_tpu_torch  # noqa: F401  (fails outside the checkout)
    from d3human_tpu_torch.ops import cuda_lib
    from d3human_tpu_torch.utils.backend import configure_backends

    configure_backends()
    smi = smi_line()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    cuda_lib.build(force=True)
    emit("build", seconds=time.perf_counter() - t0,
         sources=[f"d3human_tpu_torch/csrc/{s}.cu" for s in cuda_lib.SOURCES])

    phase_small(seed_steps=50)

    t0 = time.perf_counter()
    sc = build_scene("full", "cuda", SEED_STEPS)
    torch.cuda.synchronize()
    emit("scene", seconds=time.perf_counter() - t0, grid_dims=sc["grid_dims"],
         n_verts=sc["n_verts"], n_tets=sc["n_tets"], n_edges=sc["n_edges"],
         texture_resolutions=sc["tex"].encoder.resolutions,
         texture_dense=sc["tex"].encoder.dense,
         pretrain_loss=sc["pretrain_loss"])
    phase_field_setup(sc, "full", FIELD_STEPS)
    emit("seq_scene", **add_seq(sc, "full"))

    rows = phase_kernels(sc)
    if "--kernels-only" in sys.argv[1:]:
        print(json.dumps({"kernels": rows}), flush=True)
        print(smi, flush=True)
        return 0
    # the fields MLP's input and hidden layers a profiled run: the grid
    # query (its points carry deform's gradient, differentiated once), the
    # fit, the validation render and the seq template's DeformMLP fused;
    # each eikonal query (differentiated twice) on the other path
    layers = sc["model"].sdf_mlp.n_hidden + 1
    paths = {"init_step": phase_step(sc, "init", INIT_STEPS)}
    phase_profile("init step", lambda: one_more_step(sc, "init"),
                  (layers, layers), ("d3h.geometry.extract",))
    phase_profile(f"sdf fit, {FIT_PROFILE_STEPS} steps",
                  lambda: profiled_fit(sc, FIT_PROFILE_STEPS),
                  (FIT_PROFILE_STEPS * layers, 0))
    paths["split_step"] = phase_step(sc, "split", SPLIT_STEPS)
    paths["validate"] = phase_validate(sc)
    phase_profile("split step", lambda: one_more_step(sc, "split"),
                  (layers, 2 * layers),
                  ("d3h.geometry.extract", "d3h.smplx.skin_weights"))
    phase_profile("validation render, cloth half",
                  lambda: validation_render(sc, 1.0), (layers, 0))
    surgery = phase_surgery(sc, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), SURGERY_DIR))
    ssc = surgery_scene(sc, surgery.pop("template"))
    phase_surgery_kernels(rows, surgery.pop("inputs"), ssc)
    paths["surgery"] = surgery
    paths["surgery_seq_step"] = phase_step(ssc, "seq", SURGERY_SEQ_STEPS,
                                           phase="surgery_seq_step")
    del ssc
    paths["seq_step"] = phase_step(sc, "seq", SEQ_STEPS)
    phase_determinism(sc)
    phase_profile("seq step", lambda: one_more_step(sc, "seq"),
                  (2 * layers, 0), SEQ_RANGES)
    phase_seq_knn(sc)
    here = os.path.dirname(os.path.abspath(__file__))
    own_group = init_world1("cuda", os.path.join(here, PAR_DIR))
    par = phase_parallel_seq(sc)
    dp = phase_dp_step(sc)
    phase_path_kernels(rows, merge_recorded(par.pop("inputs"),
                                            dp.pop("inputs")), "parallel")
    paths["parallel_seq"], paths["dp"] = par, dp
    phase_parallel_world2(sc, "cuda", os.path.join(here, PAR_DIR, "world2"),
                          "full")
    pbr = phase_pbr(sc, "cuda")
    phase_path_kernels(rows, pbr.pop("inputs"), "pbr")
    paths["pbr"] = pbr
    paths["mobilenet"] = phase_mobilenet(sc, MOBILENET_STEPS)
    aux = phase_aux(sc, "full", "cuda", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), AUX_DIR))
    phase_path_kernels(rows, aux.pop("inputs"), "aux")
    paths["aux"] = aux
    ref_root = os.path.join(here, REF_DIR)
    ref = phase_ref_grid(sc, ref_root)
    # the CLI builds everything anew: the scenes of the phases above go
    del sc
    gc.collect()
    torch.cuda.empty_cache()
    ref_whole = phase_ref_grid_uncropped("full", "cuda", REF_SEED_STEPS,
                                         ref_root)
    gc.collect()
    torch.cuda.empty_cache()
    by_name = {r["name"]: r for r in rows}
    for key, res in (("ref_grid", ref), ("ref_grid_uncropped", ref_whole)):
        phase_path_kernels(rows, res.pop("inputs"), key)
        by_name["coo_scatter_add"][key].update({
            call: dict(kernel_summary(r), shape=(
                f"N={r['N']} C={r['C']} out={r['out_rows']}"))
            for call, r in res["endpoint_scatter"].items()})
    paths["ref_grid"] = {w: {k: ref[w][k] + ref_whole[w][k] for k in ref[w]}
                         for w in ("launches", "calls")}
    phase_gt_targets("full", "cuda")
    cli = phase_cli("full", "cuda", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), CLI_DIR))
    paths["cli"] = {k: cli[k] for k in ("launches", "calls")}
    phase_cli_kernels(rows, cli.pop("inputs"))
    phase_cli_cut("full", "cuda", cli, os.path.join(here, CLI_CUT_DIR))
    paths["scorers"] = phase_scorers("full", "cuda", cli, os.path.join(
        here, CLI_CUT_DIR, "scorers"))
    phase_bake("full", "cuda", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), CLI_DIR))
    del cli
    paths["cli_parallel"] = phase_cli_parallel(
        "full", "cuda", os.path.join(here, CLI_DIR),
        os.path.join(here, CLI_PAR_DIR))
    capture_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                CAPTURE_DIR)
    phase_capture_export("full", "cuda", capture_root)
    phase_capture_data("full", "cuda", capture_root)
    gc.collect()
    torch.cuda.empty_cache()
    cap = phase_cli("full", "cuda", os.path.join(capture_root, "cli"),
                    capture=capture_root)
    paths["capture"] = {k: cap[k] for k in ("launches", "calls")}
    phase_cli_kernels(rows, cap.pop("inputs"), "capture")
    del cap
    gc.collect()
    torch.cuda.empty_cache()
    bench = phase_bench("full", "cuda", here, {
        "init": paths["init_step"]["mean_ms"],
        "split": paths["split_step"]["mean_ms"],
        "seq": paths["seq_step"]["mean_ms"]})
    paths["bench"] = {k: bench[k] for k in ("launches", "calls")}
    for r in rows:
        # launches: the kernel's launches on the driven paths (INIT_STEPS
        # init steps, SPLIT_STEPS split steps, one validation render of
        # each half, the surgery, SURGERY_SEQ_STEPS seq steps on its
        # template, SEQ_STEPS seq steps, the pbr renders, MOBILENET_STEPS
        # init and split steps with the MobileNetV2 backbone, the API-only
        # modules, the frame-parallel seq runner, the DP steps, the CLI's
        # first run on the synthetic scene, the two scorers on it, its
        # --seq-parallel run and its run on the exported capture, the
        # steps on the reference-format grids, and the timed steps of the
        # three bench runs); first_k
        # counts its count and write launches, the scatter each launch of
        # its two sum kernels, and their calls are the calls of the wrapper
        for what in ("launches", "calls"):
            r[what + "_by_path"] = {k: v[what][r["name"]]
                                    for k, v in paths.items()}
            r[what] = sum(r[what + "_by_path"].values())
            check(r[what] > 0, f"{r['name']}: no {what} on the driven paths")
            for path in ("parallel_seq", "dp"):
                n = r[what + "_by_path"][path]
                # no depth peel in training; no eikonal term in seq; the
                # seq MLP (at template points) all fused; the init and
                # split grid queries fused, their eikonals not
                none = r["name"] == "resolve_tiles_peel" or (
                    path == "parallel_seq" and r["name"] in (
                        "inclusive_scan", "bias_softplus100"))
                check(n == 0 if none else n > 0,
                      f"{r['name']}: {n} {what} on the {path} path")
    emit("paths", init_step={"steps": INIT_STEPS},
         split_step={"steps": SPLIT_STEPS},
         validate={"renders": 2, "layers": VAL_LAYERS},
         surgery={"runs": 1}, surgery_seq_step={"steps": SURGERY_SEQ_STEPS},
         seq_step={"steps": SEQ_STEPS},
         pbr={"forward_backward": PBR_RENDERS, "forward": 1,
              "shadowed_forward": 1},
         mobilenet={"init_steps": MOBILENET_STEPS,
                    "split_steps": MOBILENET_STEPS},
         aux={"modules": 6},
         parallel_seq={"frames": PAR_FRAMES, "iters": PAR_ITERS},
         dp={"stages": ["init", "split"], "batch": DP_BATCH},
         cli={"runs": 1, "scale": "full"},
         scorers={"eval_parity": 1, "score_seq_partial": 2},
         cli_parallel={"runs": 1, "scale": "full"},
         capture={"runs": 1, "scale": "full"},
         ref_grid={"cropped": {s: n for s, n in REF_STEPS},
                   "uncropped": {"init": INIT_STEPS, "split": 1}},
         bench={s: {"timed_steps": r["kernels"]["iters"]}
                for s, r in bench["runs"].items()},
         launches={k: v["launches"] for k, v in paths.items()},
         calls={k: v["calls"] for k, v in paths.items()})
    if own_group:
        import torch.distributed as dist

        dist.destroy_process_group()
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
