"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here needs a CUDA device and nvcc and
skips without one. The file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from d3human_tpu_torch.ops import compaction, raster_resolve, scatter
from d3human_tpu_torch.ops.rasterizer import bin_faces


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the hand-written kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def _binned_rows(seed, F, res, tile):
    """Fused face rows of a random triangle soup, binned on the CPU."""
    rng = np.random.default_rng(seed)
    V = 3 * F
    xy = rng.uniform(-0.9, 0.9, (V, 2))
    z = rng.uniform(0.2, 0.8, (V, 1))
    clip = np.concatenate([xy, z, np.ones((V, 1))], 1).astype(np.float32)
    faces = rng.integers(0, V, (F, 3)).astype(np.int32)
    return bin_faces(torch.as_tensor(clip), torch.as_tensor(faces),
                     torch.ones(F, dtype=torch.bool), res, tile=tile,
                     max_faces_per_tile=256, bin_expand=8, max_global=128)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,p", [(4_800_000, 262_144, 0.05),
                                   (1_166_400, 291_600, 0.1),
                                   (1000, 64, 0.0)])
def test_cuda_first_k_equals_plain(cuda_device, n, k, p):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    m = torch.rand(n, generator=g, device=cuda_device) < p
    torch.testing.assert_close(compaction.first_k_indices(m, k, n),
                               compaction.first_k_plain(m, k, n),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("N,V,C,srt,hot", [
    (874_800, 1_048_576, 8, False, 0.0),
    (874_800, 1_048_576, 8, False, 0.75),   # padded slots on one vertex
    (50_000, 2000, 16, False, 0.0),
    (291_600, 1_166_400, 4, True, 0.0),
    (874_800, 1_048_576, 14, False, 0.75),  # shaded fused vertex gather
    (291_600, 357_911, 16, False, 0.25),    # corner-packed hash level
    (583_200, 1_166_400, 4, False, 0.0)])   # fused 4-tap bilinear gather
def test_cuda_scatter_equals_plain_and_deterministic(cuda_device, N, V, C,
                                                     srt, hot):
    """The plain version repeats the kernel's additions in its order, so
    the two agree bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    idx = torch.randint(-5, V + 5, (N,), generator=g, device=cuda_device)
    idx[torch.rand((N,), generator=g, device=cuda_device) < hot] = 3
    if srt:
        idx = torch.sort(torch.randperm(V + 5, generator=g,
                                        device=cuda_device)[:N]).values
    vals = torch.randn((N, C), generator=g, device=cuda_device)
    before = scatter.coo_scatter_add.launches
    a = scatter.coo_scatter_add(idx, vals, V, sorted_idx=srt)
    assert scatter.coo_scatter_add.launches - before == scatter._levels(N)
    b = scatter.coo_scatter_add(idx, vals, V, sorted_idx=srt)
    assert torch.equal(a, b)
    assert torch.equal(a, scatter.coo_scatter_add_plain(idx, vals, V, srt))


@pytest.mark.cuda
@pytest.mark.parametrize("peel", [False, True])
def test_cuda_resolve_equals_plain(cuda_device, peel):
    b = _binned_rows(seed=5, F=400, res=(64, 256), tile=(8, 128))
    rows = b.tile_rows.to(cuda_device)
    ntx = b.grid[1]
    floor = (raster_resolve.resolve_tiles(rows, (8, 128), ntx)
             if peel else None)
    got = raster_resolve.resolve_tiles(rows, (8, 128), ntx, floor=floor)
    want = raster_resolve.resolve_tiles_plain(rows, (8, 128), ntx,
                                              floor=floor)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_rasterize_layers_equal_plain(cuda_device, monkeypatch):
    """``rasterize(layers=3)`` with the kernel against the same peel loop
    over the plain resolve, on the same card tensors: ids and depths of
    every layer exact, 3 launches of which 2 with a floor."""
    from d3human_tpu_torch.ops import rasterizer

    rng = np.random.default_rng(7)
    F = 600
    V = 3 * F
    clip = np.concatenate([rng.uniform(-0.9, 0.9, (V, 2)),
                           rng.uniform(0.2, 0.8, (V, 1)), np.ones((V, 1))],
                          1).astype(np.float32)
    args = (torch.as_tensor(clip).to(cuda_device),
            torch.as_tensor(rng.integers(0, V, (F, 3)).astype(np.int32)).to(
                cuda_device),
            torch.ones(F, dtype=torch.bool, device=cuda_device), (64, 256))
    rt = raster_resolve.resolve_tiles
    before = (rt.launches, rt.floor_launches)
    got = rasterizer.rasterize(*args, layers=3)
    assert (rt.launches - before[0], rt.floor_launches - before[1]) == (3, 2)
    monkeypatch.setattr(
        rasterizer, "resolve_tiles",
        lambda rows, tile, ntx, floor=None:
        raster_resolve.resolve_tiles_plain(rows, tile, ntx, floor))
    want = rasterizer.rasterize(*args, layers=3)
    assert (rt.launches - before[0], rt.floor_launches - before[1]) == (3, 2)
    hits = [int((lay.tri_id > 0).sum()) for lay in got]
    assert hits[0] > hits[1] > hits[2] > 0
    for a, b in zip(got, want):
        assert torch.equal(a.tri_id, b.tri_id)
        assert torch.equal(a.zbuf, b.zbuf)


@pytest.mark.cuda
def test_cuda_small_tick_matches_cpu(cuda_device):
    """The whole init tick and split tick on the tiny chip_smoke scene:
    kernels on the card against the plain versions on the CPU."""
    import chip_smoke

    chip_smoke.phase_small(seed_steps=30)
