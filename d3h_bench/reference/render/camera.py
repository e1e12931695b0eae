"""Camera math (a copy of ``d3human_tpu/render/camera.py``, numpy only):
screen-space intrinsics -> NDC projection, view transforms, and the
look-at / perspective helpers of the synthetic scenes."""

from __future__ import annotations

from typing import Tuple

import numpy as np

FLIP_YZ = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def ndc_from_screenspace(height, width, fx, fy, cx, cy,
                         n=0.001, f=1000.0) -> np.ndarray:
    """Perspective projection from pixel-space intrinsics
    (ref dataset_split.py:57-68)."""
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = 2 * fx / (width - 1)
    m[0, 2] = 1 - 2 * cx / (width - 1)
    m[1, 1] = -2 * fy / (height - 1)
    m[1, 2] = 1 - 2 * cy / (height - 1)
    m[2, 2] = -(f + n) / (f - n)
    m[2, 3] = -(2 * f * n) / (f - n)
    m[3, 2] = -1.0
    return m


def camera_matrices(intrinsic: np.ndarray, extrinsic: np.ndarray,
                    height: int, width: int, half: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mv, mvp, campos); ``half`` integer-halves resolution and
    intrinsics like the reference's data prep."""
    K = np.asarray(intrinsic, np.float32)
    w2c = np.asarray(extrinsic, np.float32)
    if half:
        height, width = height // 2, width // 2
        fx, fy = K[0, 0] // 2, K[1, 1] // 2
        cx, cy = K[0, 2] // 2, K[1, 2] // 2
    else:
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    proj = ndc_from_screenspace(height, width, fx, fy, cx, cy)
    mv = FLIP_YZ @ w2c
    campos = np.linalg.inv(mv)[:3, 3]
    return mv, proj @ mv, campos


def look_at(eye, center, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Right-handed lookAt view matrix."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    f = center - eye
    f /= np.linalg.norm(f)
    s = np.cross(f, up)
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def perspective(fovy=0.7, aspect=1.0, n=0.1, f=1000.0) -> np.ndarray:
    """Symmetric GL perspective."""
    y = np.tan(fovy / 2)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = 1.0 / (y * aspect)
    m[1, 1] = 1.0 / y
    m[2, 2] = -(f + n) / (f - n)
    m[2, 3] = -(2 * f * n) / (f - n)
    m[3, 2] = -1.0
    return m
