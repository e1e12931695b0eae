"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here needs a CUDA device and nvcc and
skips without one. The file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from d3human_tpu_torch.ops import (
    compaction, cuda_lib, raster_resolve, scan, scatter,
)
from d3human_tpu_torch.ops.rasterizer import bin_faces


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the hand-written kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def _binned_rows(seed, F, res, tile, bin_expand=8, small=0.0):
    """The binning of a random triangle soup, on the CPU. ``small``: the
    share of faces shrunk to a tenth (many per tile)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.9, 0.9, (F, 3, 2))
    shrink = np.where(rng.random(F) < small, 0.1, 1.0)[:, None, None]
    xy = xy[:, :1] + (xy - xy[:, :1]) * shrink
    z = rng.uniform(0.2, 0.8, (F, 3, 1))
    clip = np.concatenate([xy, z, np.ones((F, 3, 1))], -1).astype(np.float32)
    faces = np.arange(3 * F, dtype=np.int32).reshape(F, 3)
    return bin_faces(torch.as_tensor(clip.reshape(3 * F, 4)),
                     torch.as_tensor(faces), torch.ones(F, dtype=torch.bool),
                     res, tile=tile, bin_expand=bin_expand)


TB = compaction.TILE_BYTES   # mask bytes per CTA of the first_k kernel


def _paths(before=(0, 0)):
    """(fused, fallback): the fields MLP's input and hidden layers counted
    on each path (``cuda_lib.path_counts``), less ``before``."""
    n = cuda_lib.path_counts()
    return n["mlp_fused"] - before[0], n["mlp_fallback"] - before[1]


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
    # own lists past 1,024 slots and more than 128 live oversize faces
    "long": dict(seed=11, F=6000, res=(16, 256), tile=(8, 128),
                 bin_expand=1, small=0.9),
    # narrow tiles: fewer threads than a chunk of rows has 16-byte pieces
    "narrow": dict(seed=6, F=300, res=(32, 64), tile=(8, 16)),
    # tile heights that 4 does not divide: 2 pixels and 1 pixel a thread
    "two pixels": dict(seed=8, F=300, res=(36, 128), tile=(6, 64)),
    "one pixel": dict(seed=9, F=300, res=(35, 128), tile=(5, 64)),
}


def _on(b, dev):
    return b._replace(rows=b.rows.to(dev), faces=b.faces.to(dev),
                      starts=b.starts.to(dev), n_big=b.n_big.to(dev))


def _resolve(fn, b, tile, floor=None):
    """(keys, the (slot, tile) pairs counted) of one call."""
    raster_resolve.reset_pairs()
    keys = fn(b.rows, b.faces, b.starts, b.big_base, b.n_big, tile,
              b.grid[1], floor=floor)
    return keys, int(raster_resolve.walked_pairs(b.rows.device))


@pytest.mark.cuda
@pytest.mark.parametrize("peel", [False, True])
@pytest.mark.parametrize("scene", sorted(RESOLVE_SCENES))
def test_cuda_resolve_equals_plain(cuda_device, scene, peel):
    """The kernel against its plain version on the same card tensors:
    exact keys, the same bits on a second call, one launch a call (with
    a floor: one floor launch), the same (slot, tile) pairs counted."""
    kw = RESOLVE_SCENES[scene]
    tile = kw["tile"]
    b = _on(_binned_rows(**kw), cuda_device)
    if scene == "long":
        assert int((b.starts[1:] - b.starts[:-1]).max()) > 1024
        assert int(b.n_big) > 128
    floor = (_resolve(raster_resolve.resolve_tiles, b, tile)[0]
             if peel else None)
    want, want_pairs = _resolve(raster_resolve.resolve_tiles_plain, b, tile,
                                floor)
    assert (want != raster_resolve.MISS_KEY).any()
    rt = raster_resolve.resolve_tiles
    before = (rt.launches, rt.floor_launches)
    got, pairs = _resolve(rt, b, tile, floor)
    again, _ = _resolve(rt, b, tile, floor)
    assert torch.equal(got, want) and torch.equal(again, got)
    assert pairs == want_pairs > 0
    assert (rt.launches - before[0], rt.floor_launches - before[1]) == (
        2, 2 if peel else 0)


@pytest.mark.cuda
def test_cuda_resolve_all_miss_floor_leaves_early(cuda_device):
    """A floor of MISS_KEY on every pixel lets nothing through, and no
    tile is walked."""
    kw = RESOLVE_SCENES["soup"]
    b = _on(_binned_rows(**kw), cuda_device)
    floor = torch.full((b.grid[2], 8 * 128), raster_resolve.MISS_KEY,
                       dtype=torch.int64, device=cuda_device)
    got, pairs = _resolve(raster_resolve.resolve_tiles, b, kw["tile"], floor)
    assert torch.equal(got, floor) and pairs == 0


@pytest.mark.cuda
def test_cuda_rasterize_layers_equal_plain(cuda_device, monkeypatch):
    """``rasterize(layers=3)`` with the kernel against the same peel loop
    over the plain version, on the same card tensors: ids and depths of
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
    monkeypatch.setattr(rasterizer, "resolve_tiles",
                        raster_resolve.resolve_tiles_plain)
    want = rasterizer.rasterize(*args, layers=3)
    assert (rt.launches - before[0], rt.floor_launches - before[1]) == (3, 2)
    hits = [int((lay.tri_id > 0).sum()) for lay in got]
    assert hits[0] > hits[1] > hits[2] > 0
    for a, b in zip(got, want):
        assert torch.equal(a.tri_id, b.tri_id)
        assert torch.equal(a.zbuf, b.zbuf)


@pytest.mark.cuda
def test_cuda_rasterize_equals_the_reference_at_long_lists(cuda_device):
    """The port's rasterizer on the card against the benchmark's plain
    reference (no capacity) in a scene whose lists pass 1,024 slots and
    whose oversize faces pass 128: ids and depths exact."""
    from d3h_bench.reference.ops import rasterizer as ref
    from d3human_tpu_torch.ops import rasterizer

    rng = np.random.default_rng(12)
    F = 6000
    xy = rng.uniform(-0.9, 0.9, (F, 3, 2))
    shrink = np.where(rng.random(F) < 0.9, 0.1, 1.0)[:, None, None]
    xy = xy[:, :1] + (xy - xy[:, :1]) * shrink
    clip = np.concatenate([xy, rng.uniform(0.2, 0.8, (F, 3, 1)),
                           np.ones((F, 3, 1))], -1).astype(np.float32)
    args = (torch.as_tensor(clip.reshape(3 * F, 4)).to(cuda_device),
            torch.arange(3 * F, dtype=torch.int32,
                         device=cuda_device).reshape(F, 3),
            torch.ones(F, dtype=torch.bool, device=cuda_device), (16, 256))
    got = rasterizer.rasterize(*args, bin_expand=1)
    want = ref.rasterize(*args, bin_expand=1)
    assert int(got.n_max_tile) == int(want.n_max_tile) > 1024
    assert int(got.n_big) == int(want.n_big) > 128
    assert torch.equal(got.tri_id, want.tri_id.to(got.tri_id.dtype))
    assert torch.equal(got.zbuf, want.zbuf)


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


def _softplus_layer(n, c, t, seed, device):
    """A hidden layer's product z [n, c] (100 (z + b) on both sides of the
    softplus threshold 20 and far below 0), bias, tail [n, t] and an
    incoming gradient [n, c + t]."""
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn((n, c), generator=g, device=device) * 0.3
    b = torch.randn((c,), generator=g, device=device) * 0.1
    tail = torch.randn((n, t), generator=g, device=device) if t else None
    g_out = torch.randn((n, c + t), generator=g, device=device)
    return z, b, tail, g_out


def _rel_max(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,t", [
    (674_310, 256, 0),      # the SDF fit's hidden layers
    (674_310, 256, 39),     # the layer before the skip: rows of 295
    (1, 256, 0), (255, 256, 0), (257, 256, 39), (1000, 256, 51),
    (3000, 30, 0),          # no multiple of 4: one column a thread
    (513, 64, 39)])
def test_cuda_bias_softplus_equals_plain(cuda_device, n, c, t):
    """The forward equal to the plain composition bit for bit, the tail
    beside it; g_z and g_b within 1e-6 of the plain backward (g_b summed
    in double by both), g_b the same bits on a second run; one launch
    forward and two backward counted."""
    from d3human_tpu_torch.ops import bias_softplus as bs

    z, b, tail, g_out = _softplus_layer(n, c, t, n + c + t, cuda_device)
    u = 100.0 * (z + b)
    assert n < 100 or (float(u.max()) > 20.0 and float(u.min()) < -20.0)
    fn = bs.bias_softplus100
    before = (fn.launches, fn.calls)
    out = fn(z, b, tail)
    assert (fn.launches - before[0], fn.calls - before[1]) == (
        bs.LAUNCHES, 1)
    assert torch.equal(out, bs.bias_softplus100_plain(z, b, tail))
    # the gradient of h as the skip layer's product gives it: the first c
    # columns of a [n, c + t] tensor (a row stride of c + t)
    g_h, h = g_out[:, :c], out[:, :c]
    gz, gb = bs._backward_cuda(g_h, h)
    assert fn.launches - before[0] == bs.LAUNCHES + bs.GRAD_LAUNCHES
    want_z, want_b = bs.bias_softplus100_grad_plain(g_h, h)
    assert _rel_max(gz, want_z) <= 1e-6
    assert _rel_max(gb, want_b) <= 1e-6
    gz2, gb2 = bs._backward_cuda(g_h.contiguous(), h.contiguous())
    assert torch.equal(gb2, gb) and torch.equal(gz2, gz)
    assert torch.equal(bs._backward_cuda(g_h, h)[1], gb)


@pytest.mark.cuda
def test_cuda_bias_softplus_through_autograd(cuda_device):
    """The Function's gradients of z, b and the tail on the card against
    PyTorch's autograd of the composition, and an eikonal-style double
    backward of a small skip MLP against the composition MLP on the card,
    within 1e-5."""
    import torch.nn.functional as F

    from d3human_tpu_torch.models.fields import MLP, posenc
    from d3human_tpu_torch.ops.bias_softplus import bias_softplus100

    z, b, tail, g_out = _softplus_layer(4099, 256, 39, 7, cuda_device)

    def composition(z, b, tail):
        return torch.cat([F.softplus(100.0 * (z + b)) * 0.01, tail], -1)

    grads = []
    for fn in (bias_softplus100, composition):
        leaves = [x.clone().requires_grad_(True) for x in (z, b, tail)]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, g_out))
    for got, want in zip(*grads):
        assert _rel_max(got, want) <= 1e-6

    mlp = MLP(n_freq=6, d_hidden=64, n_hidden=4, skip_in=(2,))
    params = mlp.init(torch.Generator().manual_seed(3), cuda_device)
    pts = torch.rand((2000, 3), generator=torch.Generator().manual_seed(4))
    pts = (pts * 1.6 - 0.8).to(cuda_device).requires_grad_(True)

    def composition_mlp(p, x):
        emb = posenc(x, mlp.n_freq)
        h, lay = emb, p["layers"]
        for j in range(mlp.n_hidden + 1):
            if j - 1 in mlp.skip_in:
                h = torch.cat([h, emb], dim=-1)
            h = F.softplus(100.0 * (h @ lay[j]["w"] + lay[j]["b"])) * 0.01
        return h @ lay[-1]["w"] + lay[-1]["b"]

    results = []
    for fn in (mlp.apply, composition_mlp):
        leaves = [t.clone().requires_grad_(True)
                  for lay in params["layers"] for t in (lay["w"], lay["b"])]
        p = {"layers": [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
                        for i in range(len(leaves) // 2)]}
        y = fn(p, pts)
        (grad,) = torch.autograd.grad(y.sum(), pts, create_graph=True)
        loss = ((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2).mean()
        results.append((y, torch.autograd.grad(loss, leaves[:-1] + [pts])))
    (y, ws), (y0, ws0) = results
    assert torch.equal(y, y0)
    for got, want in zip(ws, ws0):
        assert _rel_max(got, want) <= 1e-5


# a pretrain_sdf step of the 6 x 256 SDF MLP: the input layer and six
# hidden layers each one forward launch of the fused product with the bias
# + softplus in its epilogue, and one input-gradient call (two launches:
# the product with the softplus derivative and the partial column sums,
# then their reduce) each, the first from the output layer's gradient
FIT_STEP_CALLS = 7


@pytest.mark.cuda
def test_cuda_pretrain_sdf_step_goes_through_the_kernel(cuda_device):
    """One step of ``GeometryModel.pretrain_sdf`` at the f3c field's width
    on 20,000 points: FIT_STEP_CALLS layers on the fused path, forward
    calls and FIT_STEP_CALLS x (1 + 2) launches of ``linear_softplus``, no
    launch of the separate bias + softplus pass; two runs from the same
    layers give the same bits."""
    import types

    from d3human_tpu_torch.config import FieldConfig
    from d3human_tpu_torch.models.fields import MLP
    from d3human_tpu_torch.models.geometry import GeometryModel
    from d3human_tpu_torch.ops import bias_softplus as bs
    from d3human_tpu_torch.ops import linear_softplus as ls

    f = FieldConfig()
    mlp = MLP(n_freq=f.n_freq, d_hidden=f.d_hidden, n_hidden=f.n_hidden,
              skip_in=f.skip_in)
    assert f.n_hidden + 1 == FIT_STEP_CALLS
    gen = torch.Generator().manual_seed(0)
    params = {"sdf_net": mlp.init(gen, cuda_device)}
    verts = (torch.rand((20_000, 3), generator=gen) - 0.5).to(cuda_device)
    geo = types.SimpleNamespace(grid=types.SimpleNamespace(verts=verts),
                                sdf_mlp=mlp, _fit=GeometryModel._fit)
    target = 0.3 - verts.norm(dim=-1)
    fn = ls.linear_softplus100
    runs = []
    for _ in range(2):
        before = (fn.launches, fn.calls, _paths()[0],
                  bs.bias_softplus100.launches)
        out, loss = GeometryModel.pretrain_sdf(geo, params, target, steps=1)
        assert (fn.launches - before[0], fn.calls - before[1],
                _paths()[0] - before[2],
                bs.bias_softplus100.launches - before[3]) == (
            FIT_STEP_CALLS * (ls.LAUNCHES + ls.GRAD_LAUNCHES),
            FIT_STEP_CALLS, FIT_STEP_CALLS, 0)
        runs.append(out["sdf_net"]["layers"])
    for a, b in zip(*runs):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


# the fit's rows (the cropped lattice and the uncropped 129^3 one), a
# ragged count and one under a tile; the input layer's depth (the
# encoding), DeformMLP's (136 + 51), a hidden layer's and the skip layer's
LS_ROWS = (674_310, 2_146_689, 1_000, 77)
LS_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", LS_ROWS)
@pytest.mark.parametrize("k,t", [(39, 0), (187, 0), (256, 39), (295, 0)])
def test_cuda_linear_softplus_equals_plain(cuda_device, n, k, t):
    """The fused forward against the plain product and pass within LS_TOL
    of the largest entry (the sum in another order), x as the first k
    columns of rows padded to 4 floats; the same bits on a second call;
    one launch counted."""
    from d3human_tpu_torch.ops import linear_softplus as ls

    g = torch.Generator(device=cuda_device).manual_seed(n + k)
    x = torch.randn((n, -(-k // 4) * 4), generator=g,
                    device=cuda_device)[:, :k] / k ** 0.5
    w = torch.randn((k, 256), generator=g, device=cuda_device) * 0.5
    b = torch.randn((256,), generator=g, device=cuda_device) * 0.1
    tail = torch.randn((n, t), generator=g, device=cuda_device) if t \
        else None
    fn = ls.linear_softplus100
    before = fn.launches
    got = fn(x, w, b, tail)
    assert fn.launches - before == ls.LAUNCHES
    assert got.shape == (n, 256 + t) and got.stride(0) % 4 == 0
    want = ls.linear_softplus100_plain(x, w, b, tail)
    assert _rel_max(got, want) <= LS_TOL
    if t:
        assert torch.equal(got[:, 256:], tail)
    assert torch.equal(fn(x, w, b, tail), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n", LS_ROWS)
@pytest.mark.parametrize("kd,rows", [(256, 256), (256, 295), (1, 256),
                                     (3, 256)])
def test_cuda_linear_softplus_dx_equals_plain(cuda_device, n, kd, rows):
    """The fused input gradient (g @ w^T)[:, :256] * -expm1(-100 h) and
    its bias column sums against the plain product and bias_softplus's plain
    backward within LS_TOL (h the first 256 columns of the skip layer's
    padded rows where w has 295 rows; kd 1 the SDF MLP's output layer's
    rank-1 gradient, kd 3 DeformMLP's); the same bits on a second call;
    two launches counted."""
    from d3human_tpu_torch.ops import linear_softplus as ls

    g = torch.Generator(device=cuda_device).manual_seed(n + kd + rows)
    gz = torch.randn((n, kd), generator=g, device=cuda_device)
    w = torch.randn((rows, kd), generator=g, device=cuda_device) * 0.1
    h = torch.rand((n, -(-rows // 4) * 4), generator=g,
                   device=cuda_device)[:, :256] * 0.05
    fn = ls.linear_softplus100
    before = fn.launches
    got = ls.linear_softplus100_dx(gz, w, h)
    assert fn.launches - before == ls.GRAD_LAUNCHES
    want = ls.linear_softplus100_dx_plain(gz, w, h)
    for a, b in zip(got, want):
        assert _rel_max(a, b) <= LS_TOL
    again = ls.linear_softplus100_dx(gz, w, h)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sdf", "deform"])
def test_cuda_fused_mlp_matches_previous_path(cuda_device, kind):
    """The MLP at points without grad on the card (the fused path, all its
    input and hidden layers) against the product + bias_softplus path on
    the card: output and every leaf's gradient within 1e-5 (rel to the
    largest entry); the eikonal's input gradient still takes that path."""
    from d3human_tpu_torch.models.fields import MLP, DeformMLP
    from d3human_tpu_torch.ops import linear_softplus as ls

    gen = torch.Generator().manual_seed(11)
    if kind == "deform":
        mlp = DeformMLP()
        extra = (torch.randn((1, 1, mlp.pose_dim), generator=gen) * 0.1
                 ).to(cuda_device)
    else:
        mlp = MLP(n_freq=6, d_hidden=256, n_hidden=6, skip_in=(3,))
        extra = None
    params = mlp.init(gen, cuda_device)
    pts = ((torch.rand((5000, 3), generator=gen) - 0.5) * 1.6).to(cuda_device)
    results = []
    for fused in (True, False):
        leaves = [t.clone().requires_grad_(True)
                  for lay in params["layers"] for t in (lay["w"], lay["b"])]
        p = {"layers": [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
                        for i in range(len(leaves) // 2)]}
        real = ls.fusable
        before = _paths()
        if not fused:
            ls.fusable = lambda *a: False
        try:
            y = mlp.apply(p, pts) if extra is None else \
                mlp.apply(p, pts, extra)
        finally:
            ls.fusable = real
        assert _paths(before) == ((mlp.n_hidden + 1, 0) if fused
                     else (0, mlp.n_hidden + 1))
        results.append((y, torch.autograd.grad((y * y).sum(), leaves)))
    (y, g), (y0, g0) = results
    assert _rel_max(y, y0) <= 1e-5
    for a, b in zip(g, g0):
        assert _rel_max(a, b) <= 1e-5
    x = pts.clone().requires_grad_(True)
    before = _paths()
    y = mlp.apply(params, x) if extra is None else mlp.apply(params, x, extra)
    torch.autograd.grad(y.sum(), x, create_graph=True)
    assert _paths(before)[1] == mlp.n_hidden + 1


# the f3c cell's cropped lattice: the init and split grid query's rows
GRID_ROWS = 674_310


@pytest.mark.cuda
def test_cuda_grid_query_with_deform_gradient_matches_previous_path(
        cuda_device, monkeypatch):
    """The SDF MLP at the f3c width at GRID_ROWS deformed grid points that
    carry ``deform``'s gradient, in a graph differentiated once (the init
    and split extraction's query): every input and hidden layer on the
    fused path, no launch of the separate bias + softplus pass; its SDF
    and the gradients of ``deform`` and of every leaf within 1e-5 (rel to
    the largest entry) of the product + bias_softplus path on the card; a
    second run gives the same bits."""
    from d3human_tpu_torch.config import FieldConfig
    from d3human_tpu_torch.models.fields import MLP
    from d3human_tpu_torch.ops import bias_softplus as bs
    from d3human_tpu_torch.ops import linear_softplus as ls

    f = FieldConfig()
    mlp = MLP(n_freq=f.n_freq, d_hidden=f.d_hidden, n_hidden=f.n_hidden,
              skip_in=f.skip_in)
    layers = mlp.n_hidden + 1
    gen = torch.Generator().manual_seed(21)
    params = mlp.init(gen, cuda_device)
    verts = ((torch.rand((GRID_ROWS, 3), generator=gen) - 0.5) * 1.6
             ).to(cuda_device)
    deform = ((torch.rand((GRID_ROWS, 3), generator=gen) - 0.5) * 0.2
              ).to(cuda_device)
    w_out = torch.randn((GRID_ROWS,), generator=gen).to(cuda_device)

    def run():
        leaves = [deform.clone().requires_grad_(True)] + [
            t.clone().requires_grad_(True) for lay in params["layers"]
            for t in (lay["w"], lay["b"])]
        p = {"layers": [{"w": leaves[1 + 2 * i], "b": leaves[2 + 2 * i]}
                        for i in range(layers + 1)]}
        before = (_paths(), bs.bias_softplus100.launches)
        sdf = mlp.apply(p, verts + 0.5 * leaves[0],
                        differentiated_once=True)[..., 0]
        grads = torch.autograd.grad((sdf * w_out).sum(), leaves)
        return (sdf, grads, _paths(before[0]),
                bs.bias_softplus100.launches - before[1])

    fused = run()
    assert fused[2:] == ((layers, 0), 0)
    again = run()
    assert torch.equal(again[0], fused[0])
    for a, b in zip(again[1], fused[1]):
        assert torch.equal(a, b)
    monkeypatch.setattr(ls, "fusable", lambda *a: False)
    prev = run()
    assert prev[2] == (0, layers)
    assert _rel_max(fused[0], prev[0]) <= 1e-5
    assert float(prev[1][0].abs().max()) > 0
    for a, b in zip(fused[1], prev[1]):
        assert _rel_max(a, b) <= 1e-5
