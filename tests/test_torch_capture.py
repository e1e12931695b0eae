"""The port's capture data path against the JAX package and the image
libraries on the CPU: the PNG reader (``utils/io.py:load_image``) against
imageio on every scanline filter and colour type and on files that cv2 and
imageio wrote, and its refusals; ``_resize`` against ``cv2.resize``;
``FrameDataset``, ``load_smplx_params`` and ``composite_background``
against the JAX package's on a non-square fixture; the reference layout
written by either package's exporter read by the other's loaders."""

import json
import os
import subprocess
import sys

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from chip_smoke import encode_png

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H_SRC, W_SRC = 40, 32          # deliberately non-square
N_FRAMES = 3
TARGETS = ("all_img", "cloth_img", "body_img", "all_normal", "cloth_normal",
           "body_normal")
CAMERA = ("mv", "mvp", "campos")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------- PNG

COLOR_CHANNELS = {0: None, 4: 2, 2: 3, 6: 4}


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("color", sorted(COLOR_CHANNELS))
def test_load_image_every_filter_and_colour_type(tmp_path, filter_type,
                                                 color):
    """Each scanline filter (written by ``chip_smoke.encode_png``) on each
    8-bit colour type: exactly the array, as imageio reads it."""
    from d3human_tpu_torch.utils.io import load_image

    rng = np.random.default_rng(10 * color + filter_type)
    C = COLOR_CHANNELS[color]
    img = rng.integers(0, 256, (23, 17) + ((C,) if C else ()), np.uint8)
    # smooth rows too, where the predictions matter
    img[:8] = np.cumsum(img[:8] % 3, axis=1).astype(np.uint8)
    path = str(tmp_path / "f.png")
    encode_png(path, img, filter_type)
    got = load_image(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, imageio.imread(path))


def test_load_image_rows_of_every_filter(tmp_path):
    """One filter type per row in turn, as libpng's adaptive filtering
    writes them."""
    from d3human_tpu_torch.utils.io import load_image

    img = np.random.default_rng(1).integers(0, 256, (30, 21, 3), np.uint8)
    path = str(tmp_path / "rows.png")
    encode_png(path, img, np.arange(30) % 5)
    np.testing.assert_array_equal(load_image(path), img)


@pytest.mark.parametrize("trns", [False, True])
def test_load_image_palette(tmp_path, trns):
    """A palette expands to RGB, as imageio gives it; with ``tRNS`` to
    RGBA, as cv2 (libpng) gives it: imageio drops the alpha there, and
    its RGB is ours."""
    from d3human_tpu_torch.utils.io import load_image

    rng = np.random.default_rng(2)
    pal = rng.integers(0, 256, (16, 3), np.uint8)
    idx = rng.integers(0, 16, (11, 13), np.uint8)
    alpha = rng.integers(0, 256, (10,), np.uint8)
    path = str(tmp_path / "p.png")
    encode_png(path, idx, 4, palette=pal, trns=alpha if trns else None)
    got = load_image(path)
    np.testing.assert_array_equal(got[..., :3], imageio.imread(path))
    np.testing.assert_array_equal(got[..., :3], pal[idx])
    if trns:
        full = np.concatenate([alpha, np.full(6, 255, np.uint8)])
        np.testing.assert_array_equal(got[..., 3], full[idx])
        bgra = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, bgra[..., [2, 1, 0, 3]])
    else:
        assert got.shape == (11, 13, 3)


@pytest.mark.parametrize("writer", ["cv2 rgb", "cv2 grey", "imageio rgb",
                                    "imageio rgba", "imageio grey"])
def test_load_image_reads_what_the_libraries_write(tmp_path, writer):
    from d3human_tpu_torch.utils.io import load_image

    rng = np.random.default_rng(3)
    lib, kind = writer.split()
    C = {"rgb": 3, "rgba": 4, "grey": None}[kind]
    img = rng.integers(0, 256, (37, 29) + ((C,) if C else ()), np.uint8)
    yy, xx = np.mgrid[:37, :29]
    img[:20] = ((xx + 3 * yy)[:20] % 256).astype(np.uint8)[
        (...,) + ((None,) if C else ())]
    path = str(tmp_path / "w.png")
    if lib == "cv2":
        cv2.imwrite(path, img[..., ::-1] if C else img)
    else:
        imageio.imwrite(path, img)
    got = load_image(path)
    np.testing.assert_array_equal(got, imageio.imread(path))
    np.testing.assert_array_equal(got, img)


def test_load_image_refusals(tmp_path):
    """16-bit, Adam7 interlace and a corrupt CRC raise ``ValueError``
    naming the file (the JAX reader divides a 16-bit image by 255)."""
    from d3human_tpu_torch.utils.io import load_image

    rng = np.random.default_rng(4)
    cases = {"deep.png": dict(img=rng.integers(0, 2 ** 16, (5, 6, 3),
                                               dtype=np.uint16)),
             "laced.png": dict(img=rng.integers(0, 256, (5, 6, 3), np.uint8),
                               interlace=1)}
    for name, kw in cases.items():
        path = str(tmp_path / name)
        encode_png(path, **kw)
        with pytest.raises(ValueError, match=name):
            load_image(path)
    path = str(tmp_path / "crc.png")
    encode_png(path, rng.integers(0, 256, (5, 6, 3), np.uint8))
    data = bytearray(open(path, "rb").read())
    data[data.index(b"IDAT") + 6] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="crc.png.*CRC"):
        load_image(path)


# ---------------------------------------------------------------- resize

def _resize(img, res):
    from d3human_tpu_torch.data.dataset import _resize

    return _resize(torch.from_numpy(img), res).numpy()


@pytest.mark.parametrize("C", [None, 3])
@pytest.mark.parametrize("res", [(40, 32), (20, 16)])
def test_resize_exact_at_1x_and_2x(C, res):
    """The identity and an exact 2x downscale equal cv2 bit for bit (the
    2x case is cv2's (a + b + c + d + 2) >> 2), also at 1080p."""
    rng = np.random.default_rng(5)
    for shape in ((40, 32), (2 * 540, 2 * 960)):
        img = rng.integers(0, 256, shape + ((C,) if C else ()), np.uint8)
        r = res if shape == (40, 32) else (shape[0] * res[0] // 40,
                                            shape[1] * res[1] // 32)
        want = cv2.resize(img, (r[1], r[0]))
        np.testing.assert_array_equal(_resize(img, r), want)


@pytest.mark.parametrize("src,res", [((40, 32), (24, 16)),
                                     ((40, 32), (64, 48)),
                                     ((37, 53), (101, 203))])
def test_resize_other_ratios_within_one_level(src, res):
    """At other ratios the port computes cv2's SIMD form of the vertical
    pass everywhere; cv2 takes its scalar form on some pixels. Found on
    these draws: equal at 40x32 -> 24x16; one level on 1.03 % of the
    values at 40x32 -> 64x48 and on 0.23 % at 37x53 -> 101x203. Held to
    one level on at most 2 % of the values."""
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, src + (3,), np.uint8)
    d = np.abs(_resize(img, res).astype(int)
               - cv2.resize(img, (res[1], res[0])).astype(int))
    assert d.max() <= 1
    assert (d > 0).mean() <= 0.02


# ---------------------------------------------------------------- dataset

def _write_png(path, arr):
    imageio.imwrite(path, arr.astype(np.uint8))


@pytest.fixture()
def capture_dir(tmp_path):
    """The fixture of ``tests/test_dataset.py``: non-square frames, masks
    with a cloth value of 200, ``key.list`` 0..2, offsets and shape."""
    base = tmp_path / "f3c"
    for sub in ("images", "all", "all_cloth_mask", "all_body_mask",
                "normal", "smplx", "smplx_optimized"):
        os.makedirs(base / sub)
    rng = np.random.default_rng(0)
    for i in range(N_FRAMES):
        _write_png(base / "images" / f"{i:04d}.png",
                   rng.integers(0, 255, (H_SRC, W_SRC, 3)))
        m = np.zeros((H_SRC, W_SRC), np.uint8)
        m[8:32, 6:26] = 255
        m[8 + i, 5] = 255                 # frames differ
        _write_png(base / "all" / f"{i:04d}.png", m)
        cloth = np.zeros_like(m)
        cloth[8:20, 6:26] = 200           # non-255 foreground still counts
        _write_png(base / "all_cloth_mask" / f"{i:04d}.png", cloth)
        body = np.where((m > 0) & (cloth == 0), 255, 0).astype(np.uint8)
        _write_png(base / "all_body_mask" / f"{i:04d}.png",
                   np.repeat(body[..., None], 3, -1))      # an RGB mask
        _write_png(base / "normal" / f"{i:04d}.png",
                   rng.integers(0, 255, (H_SRC, W_SRC, 3)))
    (base / "key.list").write_text("0\n2\n")
    np.savez(base / "smplx" / "merged_smplx.npz",
             **{k: rng.normal(size=(N_FRAMES, d)) for k, d in (
                 ("trans", 3), ("rhand_pose", 45), ("lhand_pose", 45),
                 ("jaw_pose", 3), ("reye_pose", 3), ("leye_pose", 3),
                 ("expr", 50), ("body_pose", 63), ("root_pose", 3))})
    K = np.asarray([[800.0, 0, W_SRC], [0, 800.0, H_SRC], [0, 0, 1]])
    ext = np.eye(4, dtype=np.float32)
    ext[2, 3] = 2.5
    np.savez(base / "smplx" / "cameras.npz", intrinsic=K, extrinsic=ext,
             height=np.int64(2 * H_SRC), width=np.int64(2 * W_SRC))
    for name, n in (("face_offset", 5), ("joint_offset", 55),
                    ("locator_offset", 4)):
        with open(base / "smplx_optimized" / f"{name}.json", "w") as f:
            json.dump(rng.normal(size=(n, 3)).tolist(), f)
    with open(base / "smplx_optimized" / "shape_param.json", "w") as f:
        json.dump(np.linspace(0, 1, 100).tolist(), f)
    return str(base)


def _compare_targets(got, want, where=""):
    """Masks (alphas) exactly, every other buffer within 1e-6."""
    for k in TARGETS + CAMERA:
        g, w = _np(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == np.float32, (where, k)
        if k.endswith("_img"):
            np.testing.assert_array_equal(g[..., 3], w[..., 3],
                                          err_msg=f"{where} {k}")
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                   err_msg=f"{where} {k}")
    assert got["frame_idx"] == int(want["frame_idx"]), where


@pytest.mark.parametrize("res", [(24, 16), (20, 16), (40, 32)])
def test_frame_dataset_matches_jax(capture_dir, res):
    """Every buffer of every frame of the JAX ``FrameDataset`` (imageio +
    cv2 + numpy): masks exact, the rest within 1e-6; at a non-2x ratio,
    the exact 2x ratio and the identity, (H, W) ordered."""
    from d3human_tpu.data.dataset import FrameDataset as JFrameDataset
    from d3human_tpu_torch.data.dataset import FrameDataset

    jds = JFrameDataset(capture_dir, res)
    ds = FrameDataset(capture_dir, res, device="cpu")
    assert (ds.n_images, len(ds), ds.key_frame) == (
        jds.n_images, len(jds), jds.key_frame) == (2, 2, [0, 1, 2])
    for itr in range(3):
        got = ds.frame_target(itr)
        _compare_targets(got, jds.frame_target(itr), f"itr {itr}")
        assert got["all_img"].shape == res + (4,)
    # the kept frame: decoding it again gives the same arrays
    assert ds.decode(ds.key_frame[0]) is ds.decode(ds.key_frame[0])
    for k, v in ds.smplx_params.items():
        np.testing.assert_array_equal(v, jds.smplx_params[k])


def test_frame_dataset_detail_branch(capture_dir, tmp_path):
    from d3human_tpu.data.dataset import FrameDataset as JFrameDataset
    from d3human_tpu_torch.data.dataset import FrameDataset

    proc = tmp_path / "process"
    os.makedirs(proc)
    rng = np.random.default_rng(7)
    np.savez(proc / "merge_body_cloth.npz", v=rng.normal(size=(9, 3)),
             f=rng.integers(0, 9, (5, 3)), face_labels=np.arange(5) % 2)
    np.savez(proc / "inside_body_index.npz",
             inside_body_index=np.arange(4), outside_body_index=np.arange(5))
    want = JFrameDataset(capture_dir, (24, 16), detail=True,
                         process_path=str(proc)).template
    got = FrameDataset(capture_dir, (24, 16), detail=True,
                       process_path=str(proc), device="cpu").template
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert FrameDataset(capture_dir, (24, 16), device="cpu").template is None


def test_frame_dataset_names_a_missing_file(capture_dir):
    from d3human_tpu_torch.data.dataset import FrameDataset

    for i in (1, 2):              # two training frames need two files
        os.remove(os.path.join(capture_dir, "normal", f"000{i}.png"))
    with pytest.raises(FileNotFoundError, match="normal: 1 PNG files"):
        FrameDataset(capture_dir, (24, 16), device="cpu")
    os.remove(os.path.join(capture_dir, "key.list"))
    with pytest.raises(FileNotFoundError, match="key.list"):
        FrameDataset(capture_dir, (24, 16), device="cpu")


@pytest.mark.parametrize("optimized", [True, False])
def test_load_smplx_params_matches_jax(capture_dir, optimized):
    """With ``smplx_optimized/`` the offsets and the shape; without it
    ``shape`` zeros(1, 100) and no offsets."""
    import shutil

    from d3human_tpu.data.dataset import load_smplx_params as J
    from d3human_tpu_torch.data.dataset import load_smplx_params as T

    if not optimized:
        shutil.rmtree(os.path.join(capture_dir, "smplx_optimized"))
    root = os.path.join(capture_dir, "smplx")
    want, got = J(root), T(root)
    assert got.keys() == want.keys()
    assert ("face_offset" in got) == optimized
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["shape"].shape == (1, 100)


@pytest.mark.parametrize("bg_type", ["black", "white", "random", "checker"])
def test_composite_background_matches_jax(capture_dir, bg_type):
    """The four backgrounds; for ``random`` the JAX package's numpy draw
    is injected. Every buffer within 1e-6."""
    from d3human_tpu.data.dataset import FrameDataset as JFrameDataset
    from d3human_tpu.data.dataset import composite_background as J
    from d3human_tpu_torch.data.dataset import FrameDataset
    from d3human_tpu_torch.data.dataset import composite_background as T

    want = J(JFrameDataset(capture_dir, (24, 16)).frame_target(1), bg_type,
             np.random.default_rng(1))
    bg = (torch.from_numpy(want["background"]) if bg_type == "random"
          else None)
    got = T(FrameDataset(capture_dir, (24, 16), device="cpu").frame_target(1),
            bg_type, background=bg)
    np.testing.assert_allclose(_np(got["background"]), want["background"],
                               rtol=0, atol=1e-6)
    _compare_targets(got, want, bg_type)
    if bg_type == "random":       # the port's own draw, from a generator
        g = [T(got, "random", torch.Generator().manual_seed(3))["background"]
             for _ in range(2)]
        assert torch.equal(g[0], g[1]) and 0 <= g[0].min() < g[0].max() < 1
    with pytest.raises(ValueError):
        T(got, "gold")


# ---------------------------------------------------------------- layouts

RES, FRAMES = 32, 2


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """The reference layout written by each package's exporter."""
    from d3human_tpu_torch.scripts import export_reference_layout as port

    out = {"port": str(tmp_path_factory.mktemp("port_layout")),
           "jax": str(tmp_path_factory.mktemp("jax_layout"))}
    assert port.main(["--out", out["port"], "--res", str(RES), "--frames",
                      str(FRAMES), "--device", "cpu"]) == 0
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "export_reference_layout.py"),
         "--out", out["jax"], "--folder", "neutral-synth", "--res", str(RES),
         "--frames", str(FRAMES)],
        check=True, env=dict(os.environ, D3H_PLATFORM="cpu"), cwd=REPO,
        capture_output=True)
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_layout_read_by_both_packages(layouts, writer):
    """Either exporter's layout: the port's ``FrameDataset`` and
    ``load_smplx_npz`` against the JAX package's on it (buffers as in the
    fixture test, the body model's tables exact, forward within 1e-6)."""
    from d3human_tpu.data.dataset import FrameDataset as JFrameDataset
    from d3human_tpu.models.smplx.model import load_smplx_npz as jload
    from d3human_tpu_torch.data.dataset import FrameDataset
    from d3human_tpu_torch.models.smplx.model import load_smplx_npz

    root = layouts[writer]
    base = os.path.join(root, "neutral-synth")
    jds = JFrameDataset(base, (RES, RES))
    ds = FrameDataset(base, (RES, RES), device="cpu")
    for i in range(FRAMES):
        _compare_targets(ds.frame_target(i), jds.frame_target(i), writer)
    jm = jload(os.path.join(root, "smplx"), "neutral")
    m = load_smplx_npz(os.path.join(root, "smplx"), "neutral", device="cpu")
    assert (m.parents, m.num_betas, m.num_expr) == (
        jm.parents, jm.num_betas, jm.num_expr)
    for k in ("v_template", "shapedirs", "posedirs", "J_regressor",
              "lbs_weights"):
        np.testing.assert_array_equal(_np(getattr(m, k)),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    np.testing.assert_array_equal(m.faces, jm.faces)


def test_layouts_agree(layouts):
    """The two exporters write the same files: equal npz and json, and
    images within one level (each package renders its own ground truth:
    the oracle's float sums may round a pixel the other way)."""
    for dirpath, _, files in os.walk(layouts["jax"]):
        rel = os.path.relpath(dirpath, layouts["jax"])
        for name in files:
            a = os.path.join(layouts["port"], rel, name)
            b = os.path.join(dirpath, name)
            if name.endswith(".png"):
                d = np.abs(imageio.imread(a).astype(int)
                           - imageio.imread(b).astype(int))
                assert d.max() <= 1 and (d > 0).mean() < 0.01, (rel, name)
            elif name.endswith(".npz"):
                za, zb = np.load(a), np.load(b)
                assert sorted(za.files) == sorted(zb.files), name
                for k in zb.files:
                    np.testing.assert_allclose(za[k], zb[k], rtol=0,
                                               atol=1e-6, err_msg=k)
            else:
                assert open(a).read() == open(b).read(), name
