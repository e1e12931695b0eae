"""A cell's inputs, made from its seed by the benchmark alone (the plain
copies under ``reference/``), and handed alike to the port and to the
reference: the synthetic capture (body model, per-frame poses, camera,
every frame's ground truth from the oracle rasterizer, packed in fp16 on
the device), the tet grid's file, the seq template, the perceptual
filters and the initial parameters (the SDF MLP fitted to a capsule, the
mSDF cut at mid height); for a fit cell, the grid, the capsule's SDF at
its vertices and the SDF MLP's initial layers.

The body is fixed (the numpy seed 0 of the synthetic capsule humanoid, a
fixed subject); the seed draws the poses, the weights, the frame order and
the stage's per-iteration generators, so every seed gives the same sizes.
Caches (the lattice, the reference-format grid, the seq template) are
written once, uncompressed, under ``d3h_bench/.cache/``."""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from d3h_bench.registry import ROOT

CACHE = os.path.join(ROOT, ".cache")
BODY_SEED = 0


def log(msg: str) -> None:
    print(f"[d3h_bench] {msg}", file=sys.stderr, flush=True)


def sub_seeds(seed: int) -> Dict[str, int]:
    """Independent 63-bit seeds of a run's draws from ``--seed``."""
    state = np.random.SeedSequence(int(seed) & (2 ** 64 - 1)) \
        .generate_state(4, np.uint64) >> np.uint64(1)
    return dict(zip(("pose", "weights", "stage", "order"),
                    (int(s) for s in state)))


@dataclasses.dataclass
class Inputs:
    stage: str
    cfg: object                  # the reference's Config of the file
    bench: dict                  # the file's "bench" section
    seeds: Dict[str, int]
    body: dict                   # the body model's tables (device)
    betas: torch.Tensor
    pose: Dict[str, torch.Tensor]
    scene: object                # the reference's SyntheticScene
    targets: object              # the reference's CachedTargets
    grid_file: str
    lattice: Optional[dict]      # make_tet_grid's arguments, or None
    n_grid_verts: int
    params: dict                 # the initial parameter tree (device)
    perc_params: dict
    template: Optional[dict]     # the seq template's tensors
    frame_order: np.ndarray      # per-iteration frame ids


def _frame_order(stage: str, n_frames: int, seed: int,
                 n: int = 1 << 16) -> np.ndarray:
    """Frame of each iteration: init and split cycle the frames in a new
    seeded order each pass, seq trains on frame 0."""
    if stage == "seq":
        return np.zeros((n,), np.int64)
    rng = np.random.default_rng(seed)
    passes = -(-n // n_frames)
    return np.concatenate([rng.permutation(n_frames)
                           for _ in range(passes)])[:n]


def _scene(cfg, n_frames: int, pose_seed: int, device):
    """The synthetic capture at the render resolution (the reference's
    ``make_scene`` with the body's seed fixed and the poses' drawn)."""
    from d3h_bench.reference.data import synthetic as syn
    from d3h_bench.reference.models.smplx.deformer import SMPLXDeformer
    from d3h_bench.reference.models.smplx.model import synthetic_body_model
    from d3h_bench.reference.render.camera import look_at, perspective

    res = tuple(cfg.render.train_res)
    model = synthetic_body_model(seed=BODY_SEED, device=device)
    deformer = SMPLXDeformer(model)
    betas = torch.zeros((1, model.num_betas), device=device)
    canon = deformer.initialize(betas)
    rng = np.random.default_rng(pose_seed)
    body_pose = np.zeros((n_frames, 63), np.float32)
    body_pose[:, :6] = rng.normal(size=(n_frames, 6)) * 0.1
    root_pose = np.zeros((n_frames, 3), np.float32)
    root_pose[:, 1] = np.linspace(0, 2 * np.pi * (n_frames - 1) / n_frames,
                                  n_frames)
    trans = np.zeros((n_frames, 3), np.float32)
    trans[:, 0] = np.linspace(-0.03, 0.03, n_frames)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    def z(n):
        return torch.zeros((n_frames, n), device=device)

    pose = {"shape": betas, "trans": t(trans), "root_pose": t(root_pose),
            "body_pose": t(body_pose), "jaw_pose": z(3), "leye_pose": z(3),
            "reye_pose": z(3), "lhand_pose": z(45), "rhand_pose": z(45),
            "expr": z(model.num_expr)}
    mv = look_at(eye=(0.0, 0.0, 2.2), center=(0.0, 0.0, 0.0))
    proj = perspective(fovy=0.9, aspect=res[1] / res[0])
    scene = syn.SyntheticScene(
        model=model, deformer=deformer, canon=canon, pose_params=pose,
        mvp=t(proj @ mv), mv=t(mv), campos=t(np.linalg.inv(mv)[:3, 3]),
        resolution=res, n_frames=n_frames,
        garment_faces=syn.garment_labels(model.v_template.cpu().numpy(),
                                         model.faces))
    return scene


def _grid(cfg, bench: dict, scene, device):
    """(file, make_tet_grid's arguments or None, vertex positions): the
    lattice over ``geometry.aabb`` at ``gshell_grid`` cells an axis,
    cropped to the canonical template's box + ``geometry.grid_crop``,
    cached in make_tet_grid's layout; or, with ``bench.grid_layout``
    "reference", the whole lattice written once as the reference's tet
    grid file ({vertices, indices})."""
    from d3h_bench.reference.ops import tet_grid as tg

    g = cfg.geometry
    a = tuple(float(x) for x in g.aabb)
    bounds = (a[:3], a[3:])
    name = bench.get("cache_name", "grid")
    if bench.get("grid_layout", "lattice") == "reference":
        path = os.path.join(CACHE, f"{name}_reference.npz")
        if not os.path.exists(path):
            log(f"writing the reference-format grid {path}")
            lat = tg.make_tet_grid(res=g.grid_res, bounds=bounds,
                                   y_offset=g.grid_y_offset,
                                   scale=g.grid_scale, device="cpu")
            tmp = path + ".tmp.npz"
            tg.save_reference_tet_grid(tmp, lat.verts.numpy(),
                                       lat.tets.numpy())
            os.replace(tmp, path)
            del lat
        with np.load(path) as z:
            v = np.asarray(z["vertices"], np.float32)
        v[:, 1] += tg.REF_Y_OFFSET
        v *= tg.REF_SCALE
        return path, None, torch.as_tensor(v, device=device)
    crop = None
    if g.grid_crop > 0:
        crop = tg.template_crop_box(scene.canon.vs_template[0].cpu().numpy(),
                                    g.grid_crop)
    args = dict(res=g.grid_res, bounds=bounds, y_offset=g.grid_y_offset,
                scale=g.grid_scale, crop_box=crop)
    path = os.path.join(CACHE, f"{name}_lattice.npz")
    if not os.path.exists(path):
        log(f"writing the lattice {path}")
        tg.make_tet_grid(**args, device="cpu", cache_path=path)
    with np.load(path) as z:
        v = np.asarray(z["verts"], np.float32)
    return path, args, torch.as_tensor(v, device=device)


def capsule_sdf(pts: torch.Tensor) -> torch.Tensor:
    """Capsule along y (radius 0.24, |y| <= 0.35), positive inside."""
    seg = pts[:, 1].clamp(-0.35, 0.35)
    ax = torch.stack([torch.zeros_like(seg), seg, torch.zeros_like(seg)], -1)
    return 0.24 - torch.linalg.norm(pts - ax, dim=-1)


def _params(cfg, bench: dict, verts: torch.Tensor, pose: dict,
            n_frames: int, seed: int, device) -> dict:
    """The initial tree, drawn on the device from ``seed``: the SDF MLP
    fitted by ``bench.sdf_seed_steps`` full-batch Adam steps to the capsule
    at ``bench.sdf_fit_points`` points drawn in the grid's box, the mSDF
    cut at mid height, zero deformation, the DeformMLPs with their output
    layer scaled by 1e-3 (offsets near zero, as the stage's pretraining
    leaves them), the latents, the texture and the light."""
    from d3h_bench.reference.models.fields import MLP, DeformMLP
    from d3h_bench.reference.models.geometry import GeometryModel
    from d3h_bench.reference.models.texture import MLPTexture3D
    from d3h_bench.reference.render.light import create_trainable_env

    f = cfg.field
    gen = torch.Generator(device=device).manual_seed(seed)
    sdf = MLP(n_freq=f.n_freq, d_hidden=f.d_hidden, n_hidden=f.n_hidden,
              skip_in=f.skip_in, d_out=1)
    nonrigid = DeformMLP(n_freq=f.n_freq_deform, d_hidden=f.d_hidden,
                         n_hidden=f.n_hidden, skip_in=f.skip_in,
                         pose_dim=f.pose_code_dim, d_out=3)
    lo, hi = verts.min(0).values, verts.max(0).values
    pts = lo + (hi - lo) * torch.rand(
        (int(bench.get("sdf_fit_points", 1 << 18)), 3), generator=gen,
        device=device)
    tgt = capsule_sdf(pts)
    net, _ = GeometryModel._fit(
        sdf.init(gen, device),
        lambda n: ((sdf.apply(n, pts)[..., 0] - tgt) ** 2).mean(),
        int(bench.get("sdf_seed_steps", 100)), 1e-3)

    def deform_init():
        p = nonrigid.init(gen, device)
        for k in ("w", "b"):
            p["layers"][-1][k] = p["layers"][-1][k] * 1e-3
        return p

    N = verts.shape[0]
    geometry = {
        "sdf_net": net,
        "msdf": torch.clamp(verts[:, 1] * 4.0, -1.0, 1.0),
        "deform": torch.zeros((N, 3), device=device),
        "nonrigid": deform_init(), "body_nonrigid": deform_init(),
        "cond": torch.rand((n_frames + 1, f.cond_dim), generator=gen,
                           device=device),
        "render_cond": torch.rand((n_frames + 1, f.cond_dim), generator=gen,
                                  device=device),
        "fix_code": 0.1 * torch.randn((1, 1, f.pose_code_dim),
                                      generator=gen, device=device)}
    tex = MLPTexture3D(cfg.texture, ([0.0] * 6, [1.0] * 6), device)
    return {"geometry": geometry, "pose": pose,
            "material": tex.init(gen),
            "light": create_trainable_env(gen, cfg.render.probe_res,
                                          device=device)}


def _template(scene, bench: dict, device) -> dict:
    """The seq template's tensors (``reference/data/synthetic.py:
    seq_bench_template``: the body subdivided at edge midpoints,
    cluster-decimated, faces labelled by height), cached on the host."""
    from d3h_bench.reference.data.synthetic import seq_bench_template

    spec = bench["seq_template"]
    path = os.path.join(
        CACHE, f"seq_template_{spec['n_subdiv']}_{spec['target_faces']}.npz")
    keys = ("v", "f", "v_labels", "face_labels", "body_vidx", "cloth_vidx",
            "body_f", "connected_faces")
    if not os.path.exists(path):
        log(f"writing the seq template {path}")
        t = seq_bench_template(scene, n_subdiv=spec["n_subdiv"],
                               target_faces=spec["target_faces"],
                               device="cpu")
        os.makedirs(CACHE, exist_ok=True)
        np.savez(path + ".tmp.npz",
                 **{k: getattr(t, k).numpy() for k in keys})
        os.replace(path + ".tmp.npz", path)
    with np.load(path) as z:
        return {k: torch.as_tensor(z[k]).to(device) for k in keys}


def make_inputs(cell: dict, seed: int, device) -> Inputs:
    """Every input of ``cell`` (``registry.workload``) for ``seed``."""
    from d3h_bench.reference.config import load_config
    from d3h_bench.reference.data.synthetic import CachedTargets
    from d3h_bench.reference.models.perceptual import make_perceptual

    os.makedirs(CACHE, exist_ok=True)
    cfg = load_config(cell["config_file"])
    bench = dict(cell["config_data"].get("bench", {}))
    traffic = cell["traffic_data"]
    stage = traffic["stage"]
    n_frames = int(traffic.get("frames", bench.get("frames", 1)))
    seeds = sub_seeds(seed)
    scene = _scene(cfg, n_frames, seeds["pose"], device)
    targets = CachedTargets(scene)
    grid_file, lattice, verts = _grid(cfg, bench, scene, device)
    params = _params(cfg, bench, verts, scene.pose_params, n_frames,
                     seeds["weights"], device)
    _, perc_params = make_perceptual(cfg.loss.perceptual_backbone, device)
    template = _template(scene, bench, device) if stage == "seq" else None
    return Inputs(stage=stage, cfg=cfg, bench=bench, seeds=seeds,
                  body=_body(scene.model),
                  betas=scene.pose_params["shape"], pose=scene.pose_params,
                  scene=scene, targets=targets, grid_file=grid_file,
                  lattice=lattice, n_grid_verts=int(verts.shape[0]),
                  params=params, perc_params=perc_params, template=template,
                  frame_order=_frame_order(stage, n_frames, seeds["order"]))


@dataclasses.dataclass
class FitInputs:
    """A fit cell's inputs: the SDF MLP's initial layers drawn from the
    seed, fitted at the grid's vertices to a target SDF there."""
    stage: str
    cfg: object                  # the reference's Config of the file
    seeds: Dict[str, int]
    body: dict
    betas: torch.Tensor
    grid_file: str
    lattice: Optional[dict]
    n_grid_verts: int
    verts: torch.Tensor          # [N, 3] the grid's vertices (device)
    target: torch.Tensor         # [N] the SDF to fit there (device)
    params: dict                 # {"sdf_net": layers} (device)
    steps_per_call: int
    lr: float


def _body(model) -> dict:
    return dict(v_template=model.v_template, shapedirs=model.shapedirs,
                posedirs=model.posedirs, J_regressor=model.J_regressor,
                lbs_weights=model.lbs_weights, faces=np.asarray(model.faces),
                parents=tuple(model.parents), num_betas=model.num_betas,
                num_expr=model.num_expr)


def make_fit_inputs(cell: dict, seed: int, device) -> FitInputs:
    """The inputs of a ``pretrain_sdf`` cell for ``seed``: the grid of the
    configuration, the capsule's SDF at its vertices, and the SDF MLP's
    layers initialised from the seed on the device."""
    from d3h_bench.reference.config import load_config
    from d3h_bench.reference.models.fields import MLP

    os.makedirs(CACHE, exist_ok=True)
    cfg = load_config(cell["config_file"])
    bench = dict(cell["config_data"].get("bench", {}))
    traffic = cell["traffic_data"]
    seeds = sub_seeds(seed)
    scene = _scene(cfg, 1, seeds["pose"], device)
    grid_file, lattice, verts = _grid(cfg, bench, scene, device)
    f = cfg.field
    mlp = MLP(n_freq=f.n_freq, d_hidden=f.d_hidden, n_hidden=f.n_hidden,
              skip_in=f.skip_in, d_out=1)
    gen = torch.Generator(device=device).manual_seed(seeds["weights"])
    return FitInputs(stage=traffic["stage"], cfg=cfg, seeds=seeds,
                     body=_body(scene.model),
                     betas=scene.pose_params["shape"], grid_file=grid_file,
                     lattice=lattice, n_grid_verts=int(verts.shape[0]),
                     verts=verts, target=capsule_sdf(verts),
                     params={"sdf_net": mlp.init(gen, device)},
                     steps_per_call=int(traffic["steps_per_call"]),
                     lr=float(traffic["lr"]))


def clone_tree(tree):
    """A deep copy of a tree of dicts, lists and tensors."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    return tree
