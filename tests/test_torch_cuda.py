"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here needs a CUDA device and nvcc and
skips without one. The file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from d3human_tpu_torch.ops import compaction, raster_resolve, scan, scatter
from d3human_tpu_torch.ops.rasterizer import bin_faces


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the hand-written kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def _binned_rows(seed, F, res, tile, mfpt=256, bin_expand=8,
                 max_global=128, small=0.0):
    """Fused face rows of a random triangle soup, binned on the CPU.
    ``small``: the share of faces shrunk to a tenth (many per tile)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.9, 0.9, (F, 3, 2))
    shrink = np.where(rng.random(F) < small, 0.1, 1.0)[:, None, None]
    xy = xy[:, :1] + (xy - xy[:, :1]) * shrink
    z = rng.uniform(0.2, 0.8, (F, 3, 1))
    clip = np.concatenate([xy, z, np.ones((F, 3, 1))], -1).astype(np.float32)
    faces = np.arange(3 * F, dtype=np.int32).reshape(F, 3)
    return bin_faces(torch.as_tensor(clip.reshape(3 * F, 4)),
                     torch.as_tensor(faces), torch.ones(F, dtype=torch.bool),
                     res, tile=tile, max_faces_per_tile=mfpt,
                     bin_expand=bin_expand, max_global=max_global)


TB = compaction.TILE_BYTES   # mask bytes per CTA of the first_k kernel


def _first_k_exact(mask, k, fill):
    """One call of the wrapper: exactly the plain version, one call and
    ``compaction.LAUNCHES`` launches counted."""
    fk = compaction.first_k_indices
    before = (fk.calls, fk.launches)
    got = fk(mask, k, fill)
    assert (fk.calls - before[0], fk.launches - before[1]) == (
        1, compaction.LAUNCHES if k and mask.numel() else 0)
    assert got.dtype == torch.int32 and got.shape == (k,)
    assert torch.equal(got, compaction.first_k_plain(mask, k, fill)), (
        mask.numel(), k)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,p", [
    (4_800_000, 262_144, 0.05),
    (1_166_400, 291_600, 0.1),
    (1000, 64, 0.0),                # all false
    (TB - 1, 2000, 0.3),            # around one and three tiles
    (TB, 2000, 0.3),
    (TB + 1, 2000, 0.3),
    (3 * TB - 1, 9000, 0.3),
    (3 * TB + 1, 9000, 0.3),
    (3 * TB + 1, 9000, 1.0),        # all true
    (13, 4, 0.5),                   # shorter than one 16-byte piece
    (2 ** 24 + 4099, 300, 1e-5)])   # beyond the JAX path's 2^24
def test_cuda_first_k_equals_plain(cuda_device, n, k, p):
    """At each size ``k`` and, from the mask's count, k below it, equal to
    it, above it, 0 and above n: exactly the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    m = torch.rand(n, generator=g, device=cuda_device) < p
    total = int(m.sum())
    for kk in sorted({k, max(total - 1, 1), total, total + 1, 0, n + 9}):
        _first_k_exact(m, kk, n)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [13, 3 * TB + 1])
@pytest.mark.parametrize("offset", [0, 1, 3, 15])
def test_cuda_first_k_views_and_byte_masks(cuda_device, n, offset):
    """A mask that starts ``offset`` bytes past a 16-byte line (a view into
    a larger tensor), as bool and as uint8 with values above 1."""
    g = torch.Generator(device=cuda_device).manual_seed(offset)
    vals = torch.randint(0, 4, (n + offset,), generator=g, device=cuda_device,
                         dtype=torch.uint8)
    vals[torch.rand(n + offset, generator=g, device=cuda_device) < 0.6] = 0
    for mask in (vals[offset:], (vals != 0)[offset:]):
        assert mask.data_ptr() % 16 == offset
        total = int((mask != 0).sum())
        for k in sorted({max(total // 2, 1), total, n + 9}):
            _first_k_exact(mask, k, -1)


@pytest.mark.cuda
def test_cuda_first_k_no_state_between_calls(cuda_device):
    """Two calls back to back on one stream, then one call captured in a
    CUDA graph and replayed three times with a new mask copied in before
    each replay: every result equals the plain version of its own mask, so
    no count of one call reaches another."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    n, k = 3 * TB + 5, 4000
    masks = [torch.rand(n, generator=g, device=cuda_device) < p
             for p in (0.3, 0.05, 0.0, 0.6, 0.1)]
    a = compaction.first_k_indices(masks[0], k, n)
    b = compaction.first_k_indices(masks[1], k, n)
    assert torch.equal(a, compaction.first_k_plain(masks[0], k, n))
    assert torch.equal(b, compaction.first_k_plain(masks[1], k, n))
    static = masks[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        compaction.first_k_indices(static, k, n)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = compaction.first_k_indices(static, k, n)
    for mask in masks[2:]:
        static.copy_(mask)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, compaction.first_k_plain(mask, k, n))


@pytest.mark.cuda
@pytest.mark.parametrize("N,V,C,srt,hot", [
    (874_800, 1_048_576, 8, False, 0.0),
    (874_800, 1_048_576, 8, False, 0.75),   # padded slots on one vertex
    (50_000, 2000, 16, False, 0.0),
    (291_600, 1_166_400, 4, True, 0.0),
    (874_800, 1_048_576, 14, False, 0.75),  # shaded fused vertex gather
    (291_600, 357_911, 16, False, 0.25),    # corner-packed hash level
    (583_200, 1_166_400, 4, False, 0.0),    # fused 4-tap bilinear gather
    (2_359_296, 262_144, 3, False, 0.0),    # face-normal corners
    (30_000, 700, 5, False, 0.5),           # widths that are no multiple of 4
    (30_000, 700, 1, False, 0.0),
    (9_000, 40, 20, False, 0.3),            # wider than one CTA's 16 columns
    (1023, 300, 14, False, 0.0),            # around one tile and two tiles
    (1024, 300, 8, False, 0.6),
    (1025, 300, 5, False, 0.0),
    (2047, 90, 3, False, 0.0),
    (2048, 90, 4, True, 0.0),
    (2049, 90, 16, False, 0.6),
    (1, 5, 2, False, 0.0)])
def test_cuda_scatter_equals_plain_and_deterministic(cuda_device, N, V, C,
                                                     srt, hot):
    """The plain version repeats the kernels' additions in their order, so
    the two agree bit for bit; two runs of the kernels too. ``index_add_``
    sums in another order: float32 tolerance rel 1e-4 / abs 1e-4 on rows
    that take up to 2/3 of all values."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    idx = torch.randint(-5, V + 5, (N,), generator=g, device=cuda_device)
    idx[torch.rand((N,), generator=g, device=cuda_device) < hot] = 3
    if srt and N <= V:
        idx = torch.sort(torch.randperm(V + 5, generator=g,
                                        device=cuda_device)[:N]).values
    elif srt:
        idx = torch.sort(idx.clamp(min=0)).values
    vals = torch.randn((N, C), generator=g, device=cuda_device)
    before = (scatter.coo_scatter_add.launches, scatter.coo_scatter_add.calls)
    a = scatter.coo_scatter_add(idx, vals, V, sorted_idx=srt)
    assert (scatter.coo_scatter_add.launches - before[0],
            scatter.coo_scatter_add.calls - before[1]) == (
        2 if N > scatter.TILE else 1, 1)
    b = scatter.coo_scatter_add(idx, vals, V, sorted_idx=srt)
    assert torch.equal(a, b)
    assert torch.equal(a, scatter.coo_scatter_add_plain(idx, vals, V, srt))
    keep = (idx >= 0) & (idx < V)
    ref = torch.zeros((V + 1, C), dtype=torch.float64,
                      device=cuda_device).index_add_(
        0, torch.where(keep, idx, V), vals.double())[:V].float()
    torch.testing.assert_close(a, ref, rtol=1e-4, atol=1e-4 * max(
        1.0, (hot * N) ** 0.5))


@pytest.mark.cuda
def test_cuda_scatter_int64_idx_and_unaligned_vals(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    N, V, C = 5000, 800, 8
    idx = torch.randint(-2, V + 2, (N,), generator=g, device=cuda_device)
    buf = torch.randn((N * C + 3,), generator=g, device=cuda_device)
    vals = buf[3:].reshape(N, C)            # 12 bytes off a 16-byte line
    a = scatter.coo_scatter_add(idx, vals, V)
    assert torch.equal(a, scatter.coo_scatter_add(idx.int(), vals.clone(), V))
    assert torch.equal(a, scatter.coo_scatter_add_plain(idx, vals, V))


RESOLVE_SCENES = {
    "soup": dict(seed=5, F=400, res=(64, 256), tile=(8, 128)),
    # tiles that overflow their own list, live faces in the shared list
    "overflow": dict(seed=11, F=3000, res=(64, 256), tile=(8, 128), mfpt=128,
                     bin_expand=1, max_global=128, small=0.9),
    # narrow tiles: fewer threads than a block of rows has 16-byte pieces
    "narrow": dict(seed=6, F=300, res=(32, 64), tile=(8, 16), mfpt=128),
    # tile heights that 4 does not divide: 2 pixels and 1 pixel a thread
    "two pixels": dict(seed=8, F=300, res=(36, 128), tile=(6, 64)),
    "one pixel": dict(seed=9, F=300, res=(35, 128), tile=(5, 64)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("peel", [False, True])
@pytest.mark.parametrize("scene", sorted(RESOLVE_SCENES))
def test_cuda_resolve_equals_plain(cuda_device, scene, peel):
    """Every form of the kernel (copied rows or rows by face id, live
    ranges or all slots) against the plain full scan: exact keys."""
    kw = RESOLVE_SCENES[scene]
    tile = kw["tile"]
    b = _binned_rows(**kw)
    if scene == "overflow":
        assert int((b.starts[1:] - b.starts[:-1]).max()) > kw["mfpt"]
        assert int(b.global_range[1]) > 0
    ntx = b.grid[1]
    tile_rows = b.tile_rows.to(cuda_device)
    rows, all_faces = b.rows.to(cuda_device), b.all_faces.to(cuda_device)
    ranges = dict(counts=b.counts.to(cuda_device), global_range=(
        b.global_range[0], b.global_range[1].to(cuda_device)))
    floor = (raster_resolve.resolve_tiles(tile_rows, tile, ntx)
             if peel else None)
    want = raster_resolve.resolve_tiles_plain(tile_rows, tile, ntx,
                                              floor=floor)
    assert (want != raster_resolve.MISS_KEY).any()
    rt = raster_resolve.resolve_tiles
    before = (rt.launches, rt.floor_launches)
    n = 0
    for kwargs in [dict(), ranges]:
        got = raster_resolve.resolve_tiles(tile_rows, tile, ntx, floor=floor,
                                           **kwargs)
        assert torch.equal(got, want), kwargs.keys()
        got = raster_resolve.resolve_tiles_indexed(
            rows, all_faces, tile, ntx, floor=floor, **kwargs)
        assert torch.equal(got, want), kwargs.keys()
        n += 2
    assert (rt.launches - before[0], rt.floor_launches - before[1]) == (
        n, n if peel else 0)
    assert torch.equal(want, raster_resolve.resolve_tiles_plain(
        tile_rows, tile, ntx, floor=floor, **ranges))


@pytest.mark.cuda
def test_cuda_resolve_all_miss_floor_leaves_early(cuda_device):
    """A floor of MISS_KEY on every pixel lets nothing through."""
    kw = RESOLVE_SCENES["soup"]
    b = _binned_rows(**kw)
    floor = torch.full((b.grid[2], 8 * 128), raster_resolve.MISS_KEY,
                       dtype=torch.int32, device=cuda_device)
    got = raster_resolve.resolve_tiles_indexed(
        b.rows.to(cuda_device), b.all_faces.to(cuda_device), kw["tile"],
        b.grid[1], floor=floor, counts=b.counts.to(cuda_device),
        global_range=(b.global_range[0], b.global_range[1].to(cuda_device)))
    assert torch.equal(got, floor)


@pytest.mark.cuda
def test_cuda_rasterize_layers_equal_plain(cuda_device, monkeypatch):
    """``rasterize(layers=3)`` with the kernel (rows by face id, live
    ranges) against the same peel loop over the plain full scan, on the
    same card tensors: ids and depths of every layer exact, 3 launches of
    which 2 with a floor."""
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
        rasterizer, "resolve_tiles_indexed",
        lambda rows, all_faces, tile, ntx, floor=None, **ranges:
        raster_resolve.resolve_tiles_plain(rows[all_faces.long()], tile, ntx,
                                           floor))
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


@pytest.mark.cuda
def test_cuda_small_seq_tick_matches_cpu(cuda_device):
    """The seq tick on chip_smoke's tiny template (the body subdivided
    once): kernels on the card against the plain versions on the CPU,
    counters exact, rel 1e-3."""
    import chip_smoke

    cpu, gpu = chip_smoke.small_scenes(seed_steps=0)
    chip_smoke.compare_small_tick(cpu, gpu, "seq")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(1, 1), (1, 2047), (1, 2048), (1, 2049),
                                    (1, 786432), (256, 256), (3, 5000)])
def test_cuda_scan_equals_cumsum_and_repeats(cuda_device, rows, n):
    """The fixed-order scan against the CPU's torch.cumsum (double
    accumulation) within 1e-6 of the largest prefix, bit for bit across
    calls, two launches a call; vectors and rows, around one tile."""
    x = torch.rand((rows, n), generator=torch.Generator().manual_seed(n))
    x = x[0] if rows == 1 else x
    fn = scan.inclusive_scan
    before = (fn.calls, fn.launches)
    got = fn(x.cuda())
    assert (fn.calls - before[0], fn.launches - before[1]) == (
        1, scan.LAUNCHES)
    want = torch.cumsum(x.double(), -1)
    err = float((got.cpu().double() - want).abs().max())
    assert err <= 1e-6 * float(want.abs().max()), err
    assert torch.equal(fn(x.cuda()), got)
