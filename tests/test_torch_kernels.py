"""The port's three kernel modules against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold that version to the JAX function (Pallas kernels in interpret
mode where they have one). The hand-written kernels themselves are held to
their plain versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d3human_tpu.ops.compaction import _first_k_pallas
from d3human_tpu.ops.compaction import first_k_indices as jax_first_k
from d3human_tpu.ops.pallas_raster import resolve_tiles_pallas
from d3human_tpu.ops.scatter import gather_rows as jax_gather_rows
from d3human_tpu.ops.scatter import segment_add_rows as jax_segment_add
from d3human_tpu_torch.ops import compaction, cuda_lib, raster_resolve, scatter

torch.set_num_threads(1)


# ------------------------------------------------------------- first_k

TB = compaction.TILE_BYTES   # mask bytes per CTA of the kernel


@pytest.mark.parametrize("n,k,p", [
    (1000, 64, 0.05),
    (100000, 4096, 0.9),        # more set bits than capacity
    (8193, 640, 0.3),
    (5000, 5000, 1.0),          # every bit set, k == n
    (9000, 100, 0.0),           # all false -> all fill
    (3000, 4000, 0.2),          # k > n
    # around one and three tiles of the kernel
    (TB - 1, 2000, 0.3),        # k < set
    (TB, TB, 1.0),              # all true, k == set == n
    (TB + 1, 6000, 0.3),        # set < k < n
    (3 * TB - 1, 3 * TB + 7, 0.5),   # k > n
    (3 * TB + 1, 4096, 0.02),   # set < k
    (3 * TB + 1, 0, 0.3),       # k == 0
    (13, 4, 0.5),               # shorter than one 16-byte piece
    (13, 20, 0.5),
])
def test_first_k_matches_nonzero_and_jax(n, k, p):
    rng = np.random.default_rng(n * 7 + k)
    m = rng.random(n) < p
    want = np.asarray(jnp.nonzero(jnp.asarray(m), size=k, fill_value=n)[0])
    got = compaction.first_k_indices(torch.as_tensor(m), k, n).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jax_first_k(jnp.asarray(m), k, n, use_pallas=False)))
    if n > 2 * 4096 and k > 0:
        np.testing.assert_array_equal(got, np.asarray(_first_k_pallas(
            jnp.asarray(m), k, n, interpret=True)))


def test_first_k_cpu_path_never_loads_a_kernel(monkeypatch):
    """A CPU tensor takes the plain version and never builds or loads the
    CUDA library, whatever its dtype; nothing is counted."""
    def refuse(*args, **kwargs):
        raise AssertionError("cuda_lib.load on the CPU path")

    monkeypatch.setattr(cuda_lib, "load", refuse)
    before = (compaction.first_k_indices.calls,
              compaction.first_k_indices.launches)
    m = torch.as_tensor(np.random.default_rng(3).random(TB + 1) < 0.4)
    want = torch.nonzero(m).reshape(-1)[:700].int()
    for mask in (m, m.to(torch.uint8) * 3, m.int()):
        assert torch.equal(compaction.first_k_indices(mask, 700, -1), want)
    assert (compaction.first_k_indices.calls,
            compaction.first_k_indices.launches) == before


def test_first_k_beyond_2_24():
    """No n < 2^24 limit on the port's side (the JAX Pallas path has one)."""
    n, k = (1 << 24) + 4099, 300
    pos = np.sort(np.random.default_rng(0).choice(n, 250, replace=False))
    pos[-1] = n - 1
    m = torch.zeros(n, dtype=torch.bool)
    m[torch.as_tensor(pos)] = True
    got = compaction.first_k_indices(m, k, -1).numpy()
    np.testing.assert_array_equal(got[:250], pos)
    assert (got[250:] == -1).all()


# ------------------------------------------------------------- scatter

def _jax_oracle(idx, vals, V):
    """tests/test_scatter.py's oracle: XLA scatter, OOB/negative dropped."""
    idxc = jnp.where((idx >= 0) & (idx < V), idx, V)
    return jnp.zeros((V + 1, vals.shape[-1])).at[idxc].add(
        vals, mode="drop")[:V]


T = scatter.TILE     # sorted rows per CTA of the tile kernel


@pytest.mark.parametrize("N,V,C,oob", [
    (5000, 2000, 14, 5),        # out of range on both sides
    (300, 100, 3, 0),
    (20000, 9000, 16, 50),
    (1000, 50000, 2, 0),        # sparse
    (4096, 512, 8, 0),          # dense
    (3000, 700, 3, 2),          # widths that are no multiple of 4
    (3000, 700, 5, 2),
    (2500, 400, 20, 1),         # wider than one CTA's 16 columns
    (T - 1, 300, 14, 3),        # just below, at and above one tile
    (T, 300, 8, 3),
    (T + 1, 300, 5, 3),
    (2 * T - 1, 90, 3, 3),      # ... and two tiles
    (2 * T, 90, 4, 3),
    (2 * T + 1, 90, 16, 3),
])
def test_coo_scatter_add_matches_oracle(N, V, C, oob):
    rng = np.random.default_rng(N + V)
    idx = rng.integers(-oob, V + oob, N).astype(np.int32)
    vals = rng.normal(size=(N, C)).astype(np.float32)
    want = np.asarray(_jax_oracle(jnp.asarray(idx), jnp.asarray(vals), V))
    got = scatter.coo_scatter_add(torch.as_tensor(idx),
                                  torch.as_tensor(vals), V).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_coo_scatter_add_hot_row_matches_oracle():
    """Most rows on one destination (the padded slots of a compacted
    gather): the run spans about 14 of the 20 tiles, so it is made of
    whole-tile carries that only the second launch adds up."""
    rng = np.random.default_rng(7)
    N, V, C = 20000, 3000, 5
    idx = rng.integers(-2, V + 2, N).astype(np.int32)
    idx[rng.random(N) < 0.7] = 1
    vals = rng.normal(size=(N, C)).astype(np.float32)
    want = np.zeros((V + 1, C))
    np.add.at(want, np.where((idx >= 0) & (idx < V), idx, V),
              vals.astype(np.float64))
    got = scatter.coo_scatter_add(torch.as_tensor(idx),
                                  torch.as_tensor(vals), V).numpy()
    # float64 reference: row 1 sums ~14,000 float32 values (sum |v| ~ 1.1e4),
    # whose float32 rounding alone reaches ~1e-4 in any order
    np.testing.assert_allclose(got, want[:V], rtol=1e-6, atol=2e-4)
    np.testing.assert_allclose(np.delete(got, 1, 0), np.delete(want[:V], 1, 0),
                               rtol=1e-6, atol=1e-6)


def test_coo_scatter_add_sorted_path():
    rng = np.random.default_rng(0)
    N, V, C = 3000, 1000, 4
    idx = np.sort(rng.integers(0, V + 20, N)).astype(np.int32)  # tail OOB
    vals = rng.normal(size=(N, C)).astype(np.float32)
    want = np.asarray(_jax_oracle(jnp.asarray(idx), jnp.asarray(vals), V))
    got = scatter.coo_scatter_add(torch.as_tensor(idx), torch.as_tensor(vals),
                                  V, sorted_idx=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("N", [0, 1, 32, 33, 1024, 1025, 40000])
def test_scatter_launch_count_is_its_levels(N, monkeypatch):
    """The wrapper counts one launch for the tile kernel and one for the
    carry kernel when there is more than one tile; the plain version makes
    the same launches, and each ends with two entries per tile."""
    calls = []
    launch = scatter._segsum_launch

    def counted(keys, vals, out, tile):
        k, v = launch(keys, vals, out, tile)
        calls.append((keys.shape[0], tile, k.shape[0]))
        return k, v

    monkeypatch.setattr(scatter, "_segsum_launch", counted)
    rng = np.random.default_rng(N)
    idx = torch.as_tensor(rng.integers(0, 50, N).astype(np.int32))
    got = scatter.coo_scatter_add_plain(idx, torch.ones((N, 2)), 50)
    assert scatter._launches(N) == len(calls)
    tiles = -(-N // T)
    if N:
        assert calls[0] == (N, T, 2 * tiles)
    if N > T:
        assert calls[1] == (2 * tiles, 2 * tiles, 2)
    np.testing.assert_array_equal(
        got[:, 0].numpy(), np.bincount(idx.numpy(), minlength=50))


def test_gather_rows_vjp_matches_jax():
    rng = np.random.default_rng(1)
    V, C = 500, 14
    table = rng.normal(size=(V, C)).astype(np.float32)
    idx = rng.integers(0, V, (700, 3)).astype(np.int32)
    cot = rng.normal(size=(700, 3, C)).astype(np.float32)
    y, vjp = jax.vjp(lambda t: jax_gather_rows(t, jnp.asarray(idx), False),
                     jnp.asarray(table))
    (want,) = vjp(jnp.asarray(cot))
    t = torch.as_tensor(table).requires_grad_(True)
    out = scatter.gather_rows(t, torch.as_tensor(idx))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    out.backward(torch.as_tensor(cot))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sorted_unique", [False, True])
def test_segment_and_sorted_scatter_vjp_match_jax(sorted_unique):
    rng = np.random.default_rng(2)
    N, V, C = 900, 400, 5
    if sorted_unique:
        idx = np.sort(rng.choice(V + 50, N // 3, replace=False))
    else:
        idx = rng.integers(-3, V + 3, N)
    idx = idx.astype(np.int32)
    vals = rng.normal(size=(idx.shape[0], C)).astype(np.float32)
    cot = rng.normal(size=(V, C)).astype(np.float32)
    y, vjp = jax.vjp(lambda v: jax_segment_add(v, jnp.asarray(idx), V, False),
                     jnp.asarray(vals))
    (want,) = vjp(jnp.asarray(cot))
    v = torch.as_tensor(vals).requires_grad_(True)
    fn = scatter.scatter_rows_sorted if sorted_unique \
        else scatter.segment_add_rows
    out = fn(v, torch.as_tensor(idx), V)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=1e-6, atol=1e-6)
    out.backward(torch.as_tensor(cot))
    np.testing.assert_array_equal(v.grad.numpy(), np.asarray(want))


# ------------------------------------------------------------- resolve

def _binned_rows(seed=3, F=60, res=(32, 64), tile=(8, 32), mfpt=64,
                 bin_expand=8, max_global=64, small=0.0):
    """Fused face rows of a random triangle soup, binned by the port.
    ``small``: the share of faces shrunk to a tenth around their first
    corner (many faces per tile; the others stay large)."""
    from d3human_tpu_torch.ops.rasterizer import bin_faces

    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.9, 0.9, (F, 3, 2))
    shrink = np.where(rng.random(F) < small, 0.1, 1.0)[:, None, None]
    xy = xy[:, :1] + (xy - xy[:, :1]) * shrink
    z = rng.uniform(0.2, 0.8, (F, 3, 1))
    clip = np.concatenate([xy, z, np.ones((F, 3, 1))], -1).astype(np.float32)
    faces = np.arange(3 * F, dtype=np.int32).reshape(F, 3)
    b = bin_faces(torch.as_tensor(clip.reshape(3 * F, 4)),
                  torch.as_tensor(faces), torch.ones(F, dtype=torch.bool),
                  res, tile=tile, max_faces_per_tile=mfpt,
                  bin_expand=bin_expand, max_global=max_global)
    return b


# an overflowing tile (more faces than max_faces_per_tile) and live faces
# in the shared list of oversize faces
OVERFLOW = dict(seed=11, F=400, mfpt=32, bin_expand=2, max_global=96,
                small=0.85)
SCENES = {"soup": dict(), "overflow": OVERFLOW}


@pytest.mark.parametrize("peel", [False, True])
def test_resolve_plain_matches_pallas_interpret(peel):
    """Keys bit for bit equal to the Pallas kernel in interpret mode, for
    the floor-free kernel and one depth-peel step."""
    tile = (8, 32)
    b = _binned_rows(tile=tile)
    ntx = b.grid[1]
    rows = b.tile_rows
    floor = None
    if peel:
        floor = raster_resolve.resolve_tiles(rows, tile, ntx)
    got = raster_resolve.resolve_tiles(rows, tile, ntx, floor=floor)
    want = resolve_tiles_pallas(
        jnp.asarray(rows.numpy()), tile, ntx, interpret=True,
        floor=None if floor is None else jnp.asarray(floor.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != raster_resolve.MISS_KEY).mean() > 0.2


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_bin_faces_ranges_are_the_live_slots(scene):
    """``all_faces < F`` holds exactly on [0, counts[t]) and on
    [g0, g0 + n_global)."""
    kw = SCENES[scene]
    b = _binned_rows(**kw)
    F = b.rows.shape[0] - 1
    NT, M = b.all_faces.shape
    assert b.all_faces.dtype == torch.int32 and b.counts.dtype == torch.int32
    g0, n_global = b.global_range
    slot = torch.arange(M)[None, :]
    want = (slot < b.counts[:, None]) | ((slot >= g0)
                                         & (slot < g0 + int(n_global)))
    assert torch.equal(b.all_faces < F, want)
    assert torch.equal(want, raster_resolve._slot_in_range(
        NT, M, b.counts, b.global_range, "cpu"))
    longest = int((b.starts[1:] - b.starts[:-1]).max())
    if scene == "overflow":
        assert longest > kw["mfpt"] == int(b.counts.max()) == g0
        assert 0 < int(n_global) <= kw["max_global"]
        assert int(b.n_big) >= int(n_global)
    else:
        assert longest == int(b.counts.max()) and int(n_global) == 0


@pytest.mark.parametrize("peel", [False, True])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_resolve_ranges_match_full_scan_and_pallas(scene, peel):
    """The plain version walking only the live ranges, as copied rows and
    through the face ids, equals its full scan and the Pallas kernel in
    interpret mode bit for bit."""
    tile = (8, 32)
    b = _binned_rows(**SCENES[scene])
    ntx = b.grid[1]
    rows = b.tile_rows
    floor = None
    if peel:
        floor = raster_resolve.resolve_tiles_plain(rows, tile, ntx)
    full = raster_resolve.resolve_tiles_plain(rows, tile, ntx, floor)
    ranged = raster_resolve.resolve_tiles(
        rows, tile, ntx, floor=floor, counts=b.counts,
        global_range=b.global_range)
    indexed = raster_resolve.resolve_tiles_indexed(
        b.rows, b.all_faces, tile, ntx, floor=floor, counts=b.counts,
        global_range=b.global_range)
    want = resolve_tiles_pallas(
        jnp.asarray(rows.numpy()), tile, ntx, interpret=True,
        floor=None if floor is None else jnp.asarray(floor.numpy()))
    np.testing.assert_array_equal(full.numpy(), np.asarray(want))
    assert torch.equal(ranged, full) and torch.equal(indexed, full)
    assert (full != raster_resolve.MISS_KEY).float().mean() > 0.03
    if scene == "overflow" and not peel:
        # a face of the shared list wins somewhere: its slots count
        g0 = b.global_range[0]
        slot = full[full != raster_resolve.MISS_KEY] & 1023
        assert bool((slot >= g0).any()) and bool((slot < g0).any())
    # ranges that are too short must show: the check can fail
    short = raster_resolve.resolve_tiles_plain(
        rows, tile, ntx, floor, counts=b.counts // 2,
        global_range=b.global_range)
    assert not torch.equal(short, full)


def test_unpack_keys_matches_jax():
    from d3human_tpu.ops.pallas_raster import unpack_keys as jax_unpack

    b = _binned_rows(seed=4)
    keys = raster_resolve.resolve_tiles(b.tile_rows, (8, 32), b.grid[1])
    faces = b.all_faces.clamp(max=59)
    tri, z = raster_resolve.unpack_keys(keys, faces)
    jt, jz = jax_unpack(jnp.asarray(keys.numpy()), jnp.asarray(faces.numpy()))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
