"""The port's frame cache on the CPU: a round trip through the native
library and through ``native=False``, within the fp16 rounding of the JAX
test (2e-3; the cloth alpha 1e-3); each package reads the other's file
exactly as it reads its own; a library that cannot be built raises, for
the cache and for the PNG reader, with no other path taken."""

import os
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

KEYS = ("all_img", "cloth_img", "body_img", "all_normal", "cloth_normal",
        "body_normal")


class FakeDataset:
    """The JAX test's random targets (numpy), or the same as tensors."""

    train_res = (16, 12)

    def __init__(self, tensors=False):
        self.tensors = tensors

    def __len__(self):
        return 3

    def frame_target(self, i):
        H, W = self.train_res
        rng = np.random.default_rng(i)
        rgb = rng.random((H, W, 3), np.float32)
        a = (rng.random((H, W, 1)) > 0.5).astype(np.float32)
        ca = a * (rng.random((H, W, 1)) > 0.5)
        ba = a - ca
        nrm = (rng.random((H, W, 3), np.float32) * 2 - 1) * a
        t = {"all_img": np.concatenate([rgb * a, a], -1),
             "cloth_img": np.concatenate([rgb * ca, ca], -1),
             "body_img": np.concatenate([rgb * ba, ba], -1),
             "all_normal": nrm.astype(np.float32),
             "cloth_normal": nrm * ca, "body_normal": nrm * ba}
        return {k: torch.from_numpy(v) for k, v in t.items()} \
            if self.tensors else t


def _jax_reader(path, res):
    """The JAX package's reader on its committed library, loaded as it is
    (its build_lib would rebuild the file in place)."""
    import d3human_tpu.native as jn
    from d3human_tpu.data.frame_cache import FrameCacheReader

    lib = str(Path(jn.__file__).with_name("libframecache.so"))
    orig = jn.build_framecache
    jn.build_framecache = lambda force=False: lib
    try:
        reader = FrameCacheReader(path, res)
    finally:
        jn.build_framecache = orig
    assert reader._native is not None
    return reader


@pytest.mark.parametrize("native", [True, False])
def test_cache_round_trip(tmp_path, native):
    from d3human_tpu_torch.data.frame_cache import (
        FrameCacheReader, build_cache, frame_bytes,
    )

    ds = FakeDataset(tensors=True)
    path = str(tmp_path / "frames.bin")
    build_cache(ds, path)
    assert os.path.getsize(path) == 32 + 3 * frame_bytes(ds.train_res)
    reader = FrameCacheReader(path, ds.train_res, native=native,
                              device="cpu")
    assert reader.n_frames == 3 and (reader._native is not None) == native
    for i in range(3):
        got, want = reader.frame(i), ds.frame_target(i)
        assert got.keys() == set(KEYS)
        for k in KEYS:
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=1e-3 if "cloth" in k else 2e-3,
                                       err_msg=k)
    with pytest.raises(IndexError):
        reader.frame(3)
    reader.close()
    with pytest.raises(ValueError):
        FrameCacheReader(path, (8, 8), native=native, device="cpu")


def test_each_package_reads_the_others_cache(tmp_path):
    """The JAX package's file read by the port, the port's by the JAX
    package: the same buffers as each reads from its own file."""
    from d3human_tpu.data.frame_cache import build_cache as jbuild
    from d3human_tpu_torch.data.frame_cache import (
        FrameCacheReader, build_cache,
    )

    res = FakeDataset.train_res
    jpath, tpath = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    jbuild(FakeDataset(), jpath)
    build_cache(FakeDataset(tensors=True), tpath)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    jr = _jax_reader(tpath, res)
    tr = FrameCacheReader(jpath, res, device="cpu")
    for i in range(3):
        got, want = tr.frame(i), jr.frame(i)
        for k in KEYS:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    jr.close()
    tr.close()


def test_failed_builds_raise(tmp_path, monkeypatch):
    """A g++ failure raises ``BuildError`` from the cache reader and from
    ``load_image``: no memmap, no Python unfilter."""
    from d3human_tpu_torch import native
    from d3human_tpu_torch.data import frame_cache
    from d3human_tpu_torch.utils import io

    path = str(tmp_path / "frames.bin")
    frame_cache.build_cache(FakeDataset(), path)
    png = str(tmp_path / "x.png")
    io.save_image(png, np.zeros((4, 5, 3), np.float32))

    def no_compiler(name, force=False):
        raise native.BuildError(f"g++ failed on {name}.cpp")

    monkeypatch.setattr(native, "build_lib", no_compiler)
    monkeypatch.setattr(frame_cache, "_lib", None)
    monkeypatch.setattr(io, "_png_lib", None)
    with pytest.raises(native.BuildError, match="framecache"):
        frame_cache.FrameCacheReader(path, FakeDataset.train_res,
                                     device="cpu")
    with pytest.raises(native.BuildError, match="png"):
        io.load_image(png)


def test_native_libraries_build_into_the_port(tmp_path):
    from d3human_tpu_torch import native

    for name in ("png", "framecache"):
        lib = native.build_lib(name)
        assert lib == native.lib_path(name) and lib.exists()
        assert not (native.SRC / f"lib{name}.so").exists()
    with open(str(tmp_path / "bad.bin"), "wb") as f:
        f.write(struct.pack("<QQQQ", 1, 1, 1, 0))
    from d3human_tpu_torch.data.frame_cache import FrameCacheReader

    with pytest.raises(ValueError, match="not a frame cache"):
        FrameCacheReader(str(tmp_path / "bad.bin"), (1, 1), device="cpu")
