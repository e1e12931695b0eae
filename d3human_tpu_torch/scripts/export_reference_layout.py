"""The synthetic scene written in the reference's on-disk capture layout
(ref dataset/dataset_split.py:109-283, load_smplx_param :82-107), so the
port's CLI runs its capture branch (no ``--synthetic``) with no licensed
data: FrameDataset, cameras.npz, merged_smplx.npz, the offset files, the
gender from the folder name and the official SMPLX_<GENDER>.npz. The
port's copy of ``scripts/export_reference_layout.py``: the same layout,
npz keys and camera.

Layout written under <out>/<folder>:
    images/*.png  all/*.png  all_body_mask/*.png  all_cloth_mask/*.png
    normal/*.png  key.list
    smplx/merged_smplx.npz  smplx/cameras.npz
    smplx_optimized/{face,joint,locator}_offset.json + shape_param.json
and <out>/smplx/SMPLX_<GENDER>.npz (the official npz layout, padded to
300 shape and 50 expression columns so that load_smplx_npz reads it).

    python -m d3human_tpu_torch.scripts.export_reference_layout \\
        --out /tmp/ref_layout --folder neutral-synth --res 256 --frames 8

``--device`` defaults to ``cuda`` (the ground truth is rendered there);
``--device cpu`` renders on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from d3human_tpu_torch.data.synthetic import make_scene
from d3human_tpu_torch.render.camera import FLIP_YZ, camera_matrices, look_at
from d3human_tpu_torch.utils.io import host, save_image


def _linear_to_srgb(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.0031308, x * 12.92,
                    1.055 * np.clip(x, 0.0031308, None) ** (1 / 2.4) - 0.055)


def _save_png(path: str, arr01: np.ndarray) -> None:
    save_image(path, np.clip(arr01, 0.0, 1.0))


def export_model_npz(model, path: str) -> None:
    """The official SMPL-X npz layout of ``model``: shapedirs
    [V, 3, 300 + 50] (shape columns, then the expression columns at 300),
    posedirs [V, 3, P], kintree_table [2, J]."""
    V = model.num_verts
    nb, ne = model.num_betas, model.num_expr
    sd = host(model.shapedirs)                      # [V, 3, nb + ne]
    shapedirs = np.zeros((V, 3, 300 + 50), np.float32)
    shapedirs[:, :, :nb] = sd[:, :, :nb]
    shapedirs[:, :, 300:300 + ne] = sd[:, :, nb:]
    pd = host(model.posedirs)                       # [(J - 1) * 9, V * 3]
    posedirs = pd.T.reshape(V, 3, pd.shape[0])
    parents = np.asarray(model.parents, np.int64)
    kintree = np.stack([parents, np.arange(len(parents))], 0)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path,
             v_template=host(model.v_template).astype(np.float32),
             shapedirs=shapedirs, posedirs=posedirs,
             J_regressor=host(model.J_regressor).astype(np.float32),
             weights=host(model.lbs_weights).astype(np.float32),
             f=np.asarray(model.faces, np.int64),
             kintree_table=kintree)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--folder", default="neutral-synth")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    H = W = args.res
    dev = torch.device(args.device)
    base = os.path.join(args.out, args.folder)
    for sub in ("images", "all", "all_body_mask", "all_cloth_mask",
                "normal", "smplx", "smplx_optimized"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)

    scene = make_scene(resolution=(H, W), n_frames=args.frames, device=dev)

    # the capture's camera: full-resolution intrinsics that integer-halve
    # (ref dataset_split.py:170-176) to the synthetic perspective's pinhole
    # (fovy 0.9); the extrinsic is world-to-camera with the y/z flip taken
    # out (the loader applies FLIP_YZ again)
    f_half = (H / 2.0) / np.tan(0.45)
    K = np.array([[2 * f_half, 0, W], [0, 2 * f_half, H], [0, 0, 1]],
                 np.float32)
    w2c = (FLIP_YZ @ look_at(eye=(0.0, 0.0, 2.2),
                             center=(0.0, 0.0, 0.0))).astype(np.float32)
    np.savez(os.path.join(base, "smplx", "cameras.npz"),
             intrinsic=K, extrinsic=w2c,
             height=np.int64(2 * H), width=np.int64(2 * W))

    # the ground truth rendered through the matrices the loader rebuilds
    mv, mvp, campos = camera_matrices(K, w2c, 2 * H, 2 * W, half=True)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    scene = dataclasses.replace(scene, mv=t(mv), mvp=t(mvp),
                                campos=t(campos))

    for i in range(args.frames):
        tg = {k: host(v) for k, v in scene.frame_target(i).items()}
        _save_png(os.path.join(base, "images", f"{i:06d}.png"),
                  _linear_to_srgb(tg["all_img"][..., :3]))
        for name, arr in (("all", tg["all_img"][..., 3]),
                          ("all_body_mask", tg["body_img"][..., 3]),
                          ("all_cloth_mask", tg["cloth_img"][..., 3])):
            m = (arr > 0.5).astype(np.float32)
            _save_png(os.path.join(base, name, f"{i:06d}.png"),
                      np.repeat(m[..., None], 3, -1))
        _save_png(os.path.join(base, "normal", f"{i:06d}.png"),
                  (tg["all_normal"][..., :3] + 1.0) / 2.0)

    with open(os.path.join(base, "key.list"), "w") as fh:
        fh.write(f"0\n{args.frames}\n")

    pp = {k: host(v) for k, v in scene.pose_params.items()}
    expr = np.zeros((args.frames, 50), np.float32)
    expr[:, :pp["expr"].shape[1]] = pp["expr"]
    np.savez(os.path.join(base, "smplx", "merged_smplx.npz"),
             trans=pp["trans"], root_pose=pp["root_pose"],
             body_pose=pp["body_pose"], jaw_pose=pp["jaw_pose"],
             leye_pose=pp["leye_pose"], reye_pose=pp["reye_pose"],
             lhand_pose=pp["lhand_pose"], rhand_pose=pp["rhand_pose"],
             expr=expr)

    J = len(scene.model.parents)
    V = scene.model.num_verts
    opt = os.path.join(base, "smplx_optimized")
    for name, shape in (("face_offset", (V, 3)), ("joint_offset", (J, 3)),
                        ("locator_offset", (J, 3)), ("shape_param", (100,))):
        with open(os.path.join(opt, f"{name}.json"), "w") as fh:
            json.dump(np.zeros(shape).tolist(), fh)

    gender = args.folder.split("-")[0] or "neutral"
    export_model_npz(scene.model, os.path.join(
        args.out, "smplx", f"SMPLX_{gender.upper()}.npz"))
    print(f"[export] wrote reference-layout capture to {base}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
