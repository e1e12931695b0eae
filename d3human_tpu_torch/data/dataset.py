"""Monocular-capture loader (counterpart of ``d3human_tpu/data/dataset.py``)
and the training-frame order.

The capture's layout on disk (the reference's ``dataset_split.py``):

    base_dir/
      images/*.png            RGB frames
      all/*.png               masks of the whole person
      all_cloth_mask/*.png    garment masks
      all_body_mask/*.png     body masks
      normal/*.png            normal maps ([0, 255] -> [-1, 1], masked)
      key.list                first and last frame ids
      smplx/merged_smplx.npz  per-frame SMPL-X parameters
      smplx/cameras.npz       intrinsic, extrinsic, height, width
      smplx_optimized/{face,joint,locator}_offset.json, shape_param.json

``FrameDataset`` decodes a frame's five PNGs on the host to uint8 (the
port's reader, ``utils/io.py:load_image``) and uploads the bytes: RGB,
normals and channel 0 of each mask, 9 bytes a pixel. The resize, the sRGB
conversion, the binarising and the packing run on the dataset's device in
float32, as the JAX package computes them with cv2 and numpy.
"""

from __future__ import annotations

import glob
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from d3human_tpu_torch.render.camera import camera_matrices
from d3human_tpu_torch.utils.io import load_image

# cv2's fixed-point INTER_LINEAR: weights in 11 bits
_COEF_BITS = 11


def _srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    """sRGB [0, 1] -> linear (ref dataset_split.py:25-42)."""
    return torch.where(x <= 0.04045, x / 12.92,
                       ((x.clamp_min(0.04045) + 0.055) / 1.055) ** 2.4)


def _linear_taps(n_src: int, n_dst: int, device):
    """cv2's INTER_LINEAR taps along one axis: for each output index the
    two source indices and their weights in 2^11: half-pixel centres, the
    offset in float32, a source index below 0 or past the last clamped
    with its fraction set to 0, weights rounded to nearest even."""
    scale = 1.0 / (n_dst / n_src)
    d = torch.arange(n_dst, dtype=torch.float64)
    f = ((d + 0.5) * scale - 0.5).to(torch.float32)
    s = torch.floor(f)
    f = f - s
    s = s.long()
    clamp = (s < 0) | (s >= n_src - 1)
    f = torch.where(clamp, torch.zeros_like(f), f)
    s = s.clamp(0, n_src - 1)
    one = float(1 << _COEF_BITS)
    w0 = torch.round((1.0 - f) * one).int()
    w1 = torch.round(f * one).int()
    return (s.to(device), (s + 1).clamp(max=n_src - 1).to(device),
            w0.to(device), w1.to(device))


def _resize(img: torch.Tensor, res) -> torch.Tensor:
    """uint8 [h, w] or [h, w, C] -> uint8 [H, W(, C)] for ``res`` = (H, W),
    as ``cv2.resize(img, (W, H))`` (INTER_LINEAR) computes it, in integer
    ops on the tensor's device. The horizontal pass sums two taps with
    11-bit weights exactly; the vertical pass is cv2's SIMD form: each
    sum shifted down 4 bits, times its 11-bit weight keeping the high 16
    bits, the two added and rounded half up by 2 bits. An exact 2x
    downscale gives (a + b + c + d + 2) >> 2, as cv2's area path does."""
    H, W = int(res[0]), int(res[1])
    if tuple(img.shape[:2]) == (H, W):
        return img
    t = img.int()
    flat = t.dim() == 2
    if flat:
        t = t[..., None]
    i0, i1, a0, a1 = _linear_taps(t.shape[1], W, t.device)
    j0, j1, b0, b1 = _linear_taps(t.shape[0], H, t.device)
    rows = t[:, i0] * a0[:, None] + t[:, i1] * a1[:, None]   # [h, W, C]
    top = ((rows[j0] >> 4) * b0[:, None, None]) >> 16
    bottom = ((rows[j1] >> 4) * b1[:, None, None]) >> 16
    out = ((top + bottom + 2) >> 2).clamp(0, 255).to(torch.uint8)
    return out[..., 0] if flat else out


def load_smplx_params(root: str) -> Dict[str, np.ndarray]:
    """Per-frame SMPL-X parameters of ``root``/merged_smplx.npz and the
    offsets and shape of ``root``/../smplx_optimized (ref
    dataset_split.py:82-107). Without those files ``shape`` is
    zeros(1, 100) and there are no offsets."""
    z = dict(np.load(os.path.join(root, "merged_smplx.npz")))

    def jread(name):
        with open(os.path.join(root, "..", "smplx_optimized", name)) as f:
            return np.asarray([json.load(f)], np.float32)

    widths = {"trans": 3, "rhand_pose": 45, "jaw_pose": 3, "reye_pose": 3,
              "expr": 50, "body_pose": 63, "root_pose": 3, "lhand_pose": 45,
              "leye_pose": 3}
    out = {k: z[k].astype(np.float32).reshape(-1, d)
           for k, d in widths.items()}
    try:
        out["face_offset"] = jread("face_offset.json")[0]
        out["joint_offset"] = jread("joint_offset.json")[0]
        out["locator_offset"] = jread("locator_offset.json")[0]
        out["shape"] = jread("shape_param.json").reshape(1, -1)
    except FileNotFoundError:
        out["shape"] = np.zeros((1, 100), np.float32)
    return out


def shuffled_indexer(n_frames: int, seed: int = 0):
    """it -> frame: a fresh random permutation of the frames each epoch,
    as the reference's shuffling DataLoader gives (train.py:585). The
    permutation of epoch e is numpy's ``default_rng((seed, e))``, so it
    depends only on (seed, e): a resumed run replays the same order, and
    the order is the JAX package's."""
    state = {"epoch": -1, "perm": None}

    def fn(it: int) -> int:
        ep, off = divmod(int(it), n_frames)
        if ep != state["epoch"]:
            state["perm"] = np.random.default_rng(
                (seed, ep)).permutation(n_frames)
            state["epoch"] = ep
        return int(state["perm"][off])

    return fn


# the five images of a frame, by the sub-directory they come from
_FOLDERS = {"rgb": "images", "normal": "normal", "all": "all",
            "cloth": "all_cloth_mask", "body": "all_body_mask"}
# one thread per file of a frame, shared by every dataset (zlib and the
# unfilter run outside the interpreter lock); threads start on first use
_DECODE_POOL = ThreadPoolExecutor(len(_FOLDERS),
                                  thread_name_prefix="png-decode")


class FrameDataset:
    """A capture's frames with the reference's preprocessing, on
    ``device``. ``key.list`` holds the first and last frame ids: there are
    ``end - begin`` training frames and ``key_frame`` has one id more.
    With ``detail`` and ``process_path`` the surgery's merged template
    (``merge_body_cloth.npz``, ``inside_body_index.npz``) is read into
    ``template`` (numpy)."""

    def __init__(self, base_dir: str, train_res, detail: bool = False,
                 process_path: Optional[str] = None, device="cuda"):
        self.base_dir = base_dir
        self.train_res = tuple(train_res)
        self.device = torch.device(device)

        with open(os.path.join(base_dir, "key.list")) as f:
            keys = [int(line.strip()) for line in f if line.strip()]
        self.begin, self.end = keys[0], keys[1]
        self.key_frame = list(range(self.begin, self.end + 1))
        self.n_images = self.end - self.begin

        self.lists = {k: sorted(glob.glob(os.path.join(base_dir, d, "*.png")))
                      for k, d in _FOLDERS.items()}
        need = self.key_frame[self.n_images - 1] + 1
        for k, d in _FOLDERS.items():
            if len(self.lists[k]) < need:
                raise FileNotFoundError(
                    f"{os.path.join(base_dir, d)}: {len(self.lists[k])} "
                    f"PNG files, key.list needs {need}")

        self.smplx_params = load_smplx_params(os.path.join(base_dir, "smplx"))

        cam = np.load(os.path.join(base_dir, "smplx", "cameras.npz"))
        mv, mvp, campos = camera_matrices(
            cam["intrinsic"], cam["extrinsic"],
            int(cam["height"]), int(cam["width"]), half=True)
        self.mv, self.mvp, self.campos = (
            torch.as_tensor(np.asarray(a, np.float32), device=self.device)
            for a in (mv, mvp, campos))

        self.template = None
        if detail and process_path is not None:
            z = np.load(os.path.join(process_path, "merge_body_cloth.npz"))
            self.template = {
                "v": z["v"].astype(np.float32),
                "f": z["f"].astype(np.int64),
                "face_labels": z["face_labels"].astype(np.int64),
            }
            bi = np.load(os.path.join(process_path, "inside_body_index.npz"))
            self.template["inside_body_index"] = bi["inside_body_index"]
            self.template["outside_body_index"] = bi["outside_body_index"]

        # 0..255 -> float32 lookups of the conversions (the same float32
        # operations per value as per pixel)
        u8 = torch.arange(256, dtype=torch.float32, device=self.device)
        self._srgb = _srgb_to_linear(u8 / 255.0)
        self._normal = u8 / 255.0 * 2.0 - 1.0
        self._last = (None, None)

    def __len__(self):
        return self.n_images

    def decode(self, idx: int) -> Dict[str, np.ndarray]:
        """The five images of frame ``idx`` as uint8 host arrays: rgb and
        normal [h, w, 3], the masks' channel 0 [h, w]. The five files are
        decoded at once on the module's shared pool; the last frame's
        arrays are kept, as the same file decodes to the same bytes."""
        if self._last[0] == idx:
            return self._last[1]
        paths = [self.lists[k][idx] for k in _FOLDERS]
        imgs = dict(zip(_FOLDERS, _DECODE_POOL.map(load_image, paths)))
        for k in ("rgb", "normal"):
            if imgs[k].ndim != 3 or imgs[k].shape[2] < 3:
                raise ValueError(f"{self.lists[k][idx]}: {imgs[k].shape} is "
                                 "not an RGB image")
            imgs[k] = imgs[k][..., :3]
        for k in ("all", "cloth", "body"):
            if imgs[k].ndim == 3:
                imgs[k] = np.ascontiguousarray(imgs[k][..., 0])
        self._last = (idx, imgs)
        return imgs

    def preprocess(self, imgs: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """The decoded uint8 images -> the target buffers on the device:
        masks binarised, then resized (the reference's order; the uint8
        rounding keeps them 0 / 1); rgb resized, then sRGB to linear; the
        normals resized, scaled to [-1, 1] and masked; rgb premultiplied
        by each mask, with the mask's sign as alpha."""
        res = self.train_res
        dev = self.device
        up = {k: torch.from_numpy(v).to(dev) for k, v in imgs.items()}

        def mask(m):
            return _resize((m > 0).to(torch.uint8), res).float()[..., None]

        rgb = self._srgb[_resize(up["rgb"], res).long()]
        msk, cloth, body = mask(up["all"]), mask(up["cloth"]), mask(up["body"])
        nrm = self._normal[_resize(up["normal"], res).long()] * msk

        def pack(m):
            return torch.cat([rgb * m, torch.sign(m)], -1)

        return {"all_img": pack(msk), "cloth_img": pack(cloth),
                "body_img": pack(body), "all_normal": nrm,
                "cloth_normal": nrm * cloth, "body_normal": nrm * body}

    def frame_target(self, itr: int) -> Dict[str, torch.Tensor]:
        """The target of iteration ``itr`` (frame ``key_frame[itr %
        n_images]``): the camera, all_img / cloth_img / body_img with
        alpha, the normals; ``frame_idx`` a Python int."""
        idx = self.key_frame[itr % self.n_images]
        out = {"frame_idx": idx, "mv": self.mv, "mvp": self.mvp,
               "campos": self.campos}
        out.update(self.preprocess(self.decode(idx)))
        return out


def composite_background(target: Dict[str, torch.Tensor], bg_type: str,
                         generator: Optional[torch.Generator] = None,
                         background: Optional[torch.Tensor] = None):
    """ref train.py:93-191 prepare_batch_*: the RGB of each image lerped
    over a background by its alpha, the background kept for the renderer.
    ``bg_type`` black, white, random (uniform [0, 1) from ``generator``,
    or ``background`` when given) or checker (8-pixel squares of 0.25 and
    0.75)."""
    img0 = target["all_img"]
    H, W = img0.shape[:2]
    dev = img0.device
    if bg_type == "black":
        bg = torch.zeros((H, W, 3), device=dev)
    elif bg_type == "white":
        bg = torch.ones((H, W, 3), device=dev)
    elif bg_type == "random":
        bg = (background.to(dev) if background is not None else
              torch.rand((H, W, 3), generator=generator, device=dev))
    elif bg_type == "checker":
        yy = torch.arange(H, device=dev)[:, None] // 8
        xx = torch.arange(W, device=dev)[None, :] // 8
        c = ((yy + xx) % 2).float() * 0.5 + 0.25
        bg = c[..., None].expand(H, W, 3).contiguous()
    else:
        raise ValueError(bg_type)
    out = dict(target)
    out["background"] = bg
    for k in ("all_img", "cloth_img", "body_img"):
        img = target[k]
        a = img[..., 3:]
        out[k] = torch.cat([bg + (img[..., :3] - bg) * a, a], -1)
    return out
