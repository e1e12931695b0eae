"""Bake the neural 3D texture of a trained run into a 2D UV texture and an
OBJ with texture coordinates (counterpart of ``scripts/bake_texture.py``).

    python -m d3human_tpu_torch.scripts.bake_texture --run <out dir> \
        --stage init --mesh <out dir>/init/watertight_imesh_final.obj \
        --res 2048 --out <dir> [--atlas lscm|grid|xatlas] [--config c.json]
        [--device cuda|cpu]

Atlases: ``lscm`` (default), charts grown by normal similarity, LSCM per
chart, shelf-packed (``pipeline/uv_unwrap.py``, on the host); ``grid``, one
right triangle per face in a ceil(sqrt(F))^2 grid of cells; ``xatlas``,
the xatlas package where it is installed (else the run stops with a
message). The material is read from the newest ``<run>/<stage>/ckp/
state_*.npz`` in the JAX package's key layout, so a checkpoint written by
either package bakes. The UV rasterization and the texture lookups run on
``--device`` (``cuda`` unless asked otherwise; without a card the run
stops). Writes ``<out>/texture_kd.png``, ``texture_ks.png`` and
``mesh_uv.obj``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from d3human_tpu_torch.config import load_config
from d3human_tpu_torch.models.texture import MLPTexture3D
from d3human_tpu_torch.render.texture2d import render_uv
from d3human_tpu_torch.train.checkpoint import latest_checkpoint, load_params
from d3human_tpu_torch.utils.io import load_obj, save_image, write_obj


def grid_atlas(n_faces: int, margin: float = 0.125):
    """Chart-per-face UV atlas: face i -> a right triangle in grid cell i,
    ``margin`` cell-fractions from the cell's sides, so bilinear taps at
    the bake resolution never cross into a neighbour. Returns
    (v_tex [3F, 2] float32, t_tex_idx [F, 3] int32)."""
    side = int(np.ceil(np.sqrt(n_faces)))
    cell = 1.0 / side
    ci = np.arange(n_faces) % side
    cj = np.arange(n_faces) // side
    x0 = ci * cell + margin * cell
    y0 = cj * cell + margin * cell
    x1 = (ci + 1) * cell - margin * cell
    y1 = (cj + 1) * cell - margin * cell
    v_tex = np.stack([
        np.stack([x0, y0], -1),
        np.stack([x1, y0], -1),
        np.stack([x0, y1], -1),
    ], axis=1).reshape(-1, 2).astype(np.float32)
    t_tex_idx = np.arange(n_faces * 3, dtype=np.int32).reshape(-1, 3)
    return v_tex, t_tex_idx


def xatlas_atlas(verts, faces):
    try:
        import xatlas
    except ImportError as e:
        raise SystemExit(
            "--atlas xatlas requested but the xatlas package is not "
            "installed in this image; use --atlas grid (chart-per-face)"
        ) from e
    vmapping, indices, uvs = xatlas.parametrize(verts, faces)
    return uvs.astype(np.float32), indices.astype(np.int32), vmapping


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", required=True, help="training out dir")
    ap.add_argument("--stage", default="init")
    ap.add_argument("--mesh", required=True, help="OBJ to bake onto "
                    "(template / canonical positions = texture coords)")
    ap.add_argument("--res", type=int, default=2048)
    ap.add_argument("--atlas", choices=("lscm", "grid", "xatlas"),
                    default="lscm")
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def texture_module(config: Optional[str], device) -> MLPTexture3D:
    """The volume texture of the training config ``config`` (None: the
    default config)."""
    cfg = load_config(config)
    r = cfg.render
    return MLPTexture3D(cfg.texture, (list(r.kd_min[:3]) + list(r.ks_min),
                                      list(r.kd_max[:3]) + list(r.ks_max)),
                        device)


def bake(args) -> dict:
    """The bake of ``args`` (``parse_args``'s namespace): writes the three
    files and returns the arrays (mask, kd, ks on the device; the atlas
    and mesh on the host), the texture module and its material, the
    checkpoint read, and the seconds of the unwrap and of the bake on the
    device."""
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("d3human_tpu_torch.scripts.bake_texture: no CUDA "
                         "device (pass --device cpu to bake on the CPU)")
    dev = torch.device(args.device)
    verts, faces = load_obj(args.mesh)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    print(f"[bake] mesh {len(verts)} verts / {len(faces)} faces", flush=True)

    t0 = time.perf_counter()
    n_charts = None
    if args.atlas == "grid":
        v_tex, t_tex_idx = grid_atlas(len(faces))
        t_pos_idx = faces
    elif args.atlas == "lscm":
        from d3human_tpu_torch.pipeline.uv_unwrap import unwrap

        v_tex, t_tex_idx, chart = unwrap(verts, faces)
        t_pos_idx = faces
        n_charts = int(chart.max()) + 1
        print(f"[bake] lscm atlas: {n_charts} charts", flush=True)
    else:
        uvs, t_tex_idx, _ = xatlas_atlas(verts, faces)
        v_tex, t_pos_idx = uvs, t_tex_idx
    unwrap_s = time.perf_counter() - t0

    ck = latest_checkpoint(os.path.join(args.run, args.stage, "ckp"))
    if ck is None:
        raise SystemExit(f"no checkpoint under {args.run}/{args.stage}/ckp")
    tex = texture_module(args.config, dev)
    template = {"params": {"material": tex.init(
        torch.Generator().manual_seed(0))}}
    material = load_params(ck, template)["params"]["material"]

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        mask, kd, ks = render_uv(
            t(verts, torch.float32), t(v_tex, torch.float32),
            t(t_tex_idx, torch.int64), t(t_pos_idx, torch.int64),
            (args.res, args.res), tex, material)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    bake_s = time.perf_counter() - t0

    os.makedirs(args.out, exist_ok=True)
    save_image(os.path.join(args.out, "texture_kd.png"),
               kd.clamp(0, 1) * mask)
    save_image(os.path.join(args.out, "texture_ks.png"),
               ks.clamp(0, 1) * mask)
    write_obj(os.path.join(args.out, "mesh_uv.obj"), verts, faces,
              uv=np.asarray(v_tex), uv_idx=np.asarray(t_tex_idx))
    print(f"[bake] wrote {args.out}/texture_kd.png, texture_ks.png, "
          f"mesh_uv.obj", flush=True)
    return dict(mask=mask, kd=kd, ks=ks, v_tex=v_tex, t_tex_idx=t_tex_idx,
                verts=verts, faces=faces, n_charts=n_charts, tex=tex,
                material=material, checkpoint=ck, unwrap_s=unwrap_s,
                bake_s=bake_s)


def main(argv: Optional[List[str]] = None) -> int:
    bake(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
