"""The port's three kernel modules against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold that version to the JAX function (Pallas kernels in interpret
mode where they have one). The hand-written kernels themselves are held to
their plain versions on the card by tests/test_torch_cuda.py.
"""

import sys

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


def test_kernel_registry_covers_every_source():
    """Every ``csrc/*.cu`` has a registered wrapper, ``reset_counts``
    zeroes every counter of the registry and ``read_counts`` reads the
    kernel table's names, launches and calls alike."""
    kernels = cuda_lib.registered()
    assert cuda_lib.SOURCES == tuple(sorted(
        p.stem for p in cuda_lib.CSRC.glob("*.cu")))
    assert {k.source for k in kernels.values()} == set(cuda_lib.SOURCES)
    # the counters live on the objects bound to the modules' names
    for k in kernels.values():
        assert getattr(sys.modules[k.fn.__module__], k.fn.__name__) is k.fn
    attrs = ("launches", "calls", "floor_launches")
    saved = {(n, a): getattr(k.fn, a) for n, k in kernels.items()
             for a in attrs if hasattr(k.fn, a)}
    paths = cuda_lib.path_counts()
    try:
        for n, a in saved:
            setattr(kernels[n].fn, a, 3)
        cuda_lib.count_path("mlp_fused", 2)
        cuda_lib.reset_counts()
        assert all(getattr(kernels[n].fn, a) == 0 for n, a in saved)
        assert not any(cuda_lib.path_counts().values())
        raster_resolve.resolve_tiles.launches = 5
        raster_resolve.resolve_tiles.floor_launches = 2
        names = {"first_k_indices", "coo_scatter_add", "resolve_tiles",
                 "resolve_tiles_peel", "inclusive_scan", "bias_softplus100",
                 "linear_softplus100"}
        counts = cuda_lib.read_counts()
        assert set(counts) == names | {"calls"}
        assert set(counts["calls"]) == names
        assert counts["resolve_tiles"] == counts["calls"]["resolve_tiles"] == 3
        assert counts["resolve_tiles_peel"] == 2
    finally:
        for (n, a), v in saved.items():
            setattr(kernels[n].fn, a, v)
        cuda_lib.count_path("mlp_fused", paths["mlp_fused"])
        cuda_lib.count_path("mlp_fallback", paths["mlp_fallback"])


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

def _soup(seed=3, F=60, small=0.0):
    """Clip-space corners [3F, 4] of a random triangle soup and its faces.
    ``small``: the share of faces shrunk to a tenth around their first
    corner (many faces per tile; the others stay large)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.9, 0.9, (F, 3, 2))
    shrink = np.where(rng.random(F) < small, 0.1, 1.0)[:, None, None]
    xy = xy[:, :1] + (xy - xy[:, :1]) * shrink
    z = rng.uniform(0.2, 0.8, (F, 3, 1))
    clip = np.concatenate([xy, z, np.ones((F, 3, 1))], -1).astype(np.float32)
    return clip.reshape(3 * F, 4), np.arange(3 * F, dtype=np.int32).reshape(
        F, 3)


def _binned_rows(seed=3, F=60, res=(32, 64), tile=(8, 32), bin_expand=8,
                 small=0.0):
    """The port's binning of ``_soup``."""
    from d3human_tpu_torch.ops.rasterizer import bin_faces

    clip, faces = _soup(seed, F, small)
    return bin_faces(torch.as_tensor(clip), torch.as_tensor(faces),
                     torch.ones(F, dtype=torch.bool), res, tile=tile,
                     bin_expand=bin_expand)


def _lists(b):
    """(each tile's own list, the shared list) of a binning, as ints."""
    st = b.starts.tolist()
    own = [b.faces[st[t]:st[t + 1]].tolist() for t in range(len(st) - 1)]
    return own, b.faces[b.big_base:b.big_base + int(b.n_big)].tolist()


def _slot_matrix(b, g0):
    """The Pallas kernel's layout of the port's lists, cutting nothing:
    [NT, M] face ids (F = the zero row), tile t's own list at slots
    [0, n_t), the shared list at [g0, g0 + n_big), M a multiple of 128."""
    own, glob = _lists(b)
    F = b.rows.shape[0] - 1
    assert max(map(len, own)) <= g0
    M = max(128, -(-(g0 + len(glob)) // 128) * 128)
    assert M <= 1024
    m = torch.full((len(own), M), F, dtype=torch.int32)
    for t, lst in enumerate(own):
        m[t, :len(lst)] = torch.tensor(lst, dtype=torch.int32)
    m[:, g0:g0 + len(glob)] = torch.tensor(glob, dtype=torch.int32)
    return m


def _as_pallas_keys(keys, b, g0):
    """The port's int64 keys ``(zq << 32) | pos`` in the Pallas kernel's
    int32 layout ``(zq << 10) | slot`` over ``_slot_matrix(b, g0)``."""
    miss = keys == raster_resolve.MISS_KEY
    zq, pos = keys >> 32, keys & 0xFFFFFFFF
    first = b.starts.long()[:-1, None]
    slot = torch.where(pos < b.big_base, pos - first,
                       g0 + pos - b.big_base)
    return torch.where(miss, (1 << 31) - 1, (zq << 10) | slot).to(
        torch.int32)


def _pallas(b, tile, g0, floor=None):
    rows = b.rows[_slot_matrix(b, g0).long()]
    return np.asarray(resolve_tiles_pallas(
        jnp.asarray(rows.numpy()), tile, b.grid[1], interpret=True,
        floor=None if floor is None else jnp.asarray(floor)))


def _resolve(b, tile, floor=None, starts=None):
    return raster_resolve.resolve_tiles(
        b.rows, b.faces, b.starts if starts is None else starts, b.big_base,
        b.n_big, tile, b.grid[1], floor=floor)


# own lists longer than twice the old binning's 32-slot cut here, and
# live faces in the shared list of oversize faces
OVERFLOW = dict(seed=11, F=400, bin_expand=2, small=0.85)
SCENES = {"soup": dict(), "overflow": OVERFLOW}


@pytest.mark.parametrize("peel", [False, True])
def test_resolve_plain_matches_pallas_interpret(peel):
    """Keys, put in the Pallas kernel's layout, bit for bit equal to the
    Pallas kernel in interpret mode, for the floor-free kernel and one
    depth-peel step."""
    tile = (8, 32)
    b = _binned_rows(tile=tile)
    g0 = max(map(len, _lists(b)[0]))
    got = _resolve(b, tile)
    want = _pallas(b, tile, g0)
    if peel:
        got = _resolve(b, tile, floor=got)
        want = _pallas(b, tile, g0, floor=want)
    np.testing.assert_array_equal(_as_pallas_keys(got, b, g0).numpy(), want)
    assert (got.numpy() != raster_resolve.MISS_KEY).mean() > 0.2


def _want_lists(clip, faces, res, tile, bin_expand):
    """Each tile's list and the shared list from the corners alone: a face
    whose screen box meets at most ``bin_expand`` tiles joins each, near to
    far by its nearest quantized depth, ties in face order; every other
    face the shared list, in the same order."""
    H, W = res
    th, tw = tile
    nty, ntx = -(-H // th), -(-W // tw)
    tri = clip[faces]
    x = (tri[..., 0] / tri[..., 3] * np.float32(0.5) + np.float32(0.5)) * W
    y = (np.float32(0.5) - tri[..., 1] / tri[..., 3] * np.float32(0.5)) * H
    zq = np.clip((tri[..., 2] / tri[..., 3]).min(1) + np.float32(1.0), 0,
                 None) * np.float32(0.5 * ((1 << 20) - 1))
    zq = np.minimum(zq, (1 << 20) - 1).astype(np.int64)
    own, big = [[] for _ in range(nty * ntx)], []
    for f in range(faces.shape[0]):
        tx = np.clip(np.floor(np.array([x[f].min(), x[f].max()]) / tw), 0,
                     ntx - 1).astype(int)
        ty = np.clip(np.floor(np.array([y[f].min(), y[f].max()]) / th), 0,
                     nty - 1).astype(int)
        tiles = [j * ntx + i for j in range(ty[0], ty[1] + 1)
                 for i in range(tx[0], tx[1] + 1)]
        for t in (tiles if len(tiles) <= bin_expand else []):
            own[t].append((zq[f], f))
        if len(tiles) > bin_expand:
            big.append((zq[f], f))
    return [[f for _, f in sorted(lst)] for lst in own], \
        [f for _, f in sorted(big)]


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_bin_faces_ranges_are_the_live_slots(scene):
    """Each tile's range of the flat list is exactly its faces, near to
    far, and the shared list exactly the oversize faces, nearest first:
    nothing is cut, however long a list."""
    kw = dict(SCENES[scene])
    b = _binned_rows(**kw)
    assert b.faces.dtype == torch.int32 and b.starts.dtype == torch.int32
    F = kw.get("F", 60)
    assert b.big_base == F * kw.get("bin_expand", 8)
    clip, faces = _soup(kw.get("seed", 3), F, kw.get("small", 0.0))
    own, glob = _lists(b)
    want_own, want_glob = _want_lists(clip, faces, (32, 64), (8, 32),
                                      kw.get("bin_expand", 8))
    assert own == want_own and glob == want_glob
    assert int(b.n_big) == len(want_glob)
    longest = max(map(len, own))
    if scene == "overflow":
        # the old binning kept 32 own slots here and 96 shared ones
        assert longest > 2 * 32 and len(glob) > 0
    else:
        assert len(glob) == 0


@pytest.mark.parametrize("peel", [False, True])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_resolve_ranges_match_full_scan_and_pallas(scene, peel):
    """The plain version walking each tile's whole list equals the Pallas
    kernel in interpret mode over a slot matrix that holds those lists,
    bit for bit, and counts the (slot, tile) pairs it walked."""
    tile = (8, 32)
    b = _binned_rows(**SCENES[scene])
    own, glob = _lists(b)
    g0 = max(map(len, own))
    floor = pfloor = None
    if peel:
        floor, pfloor = _resolve(b, tile), _pallas(b, tile, g0)
    counter = raster_resolve.walked_pairs("cpu")
    before = int(counter)
    got = _resolve(b, tile, floor=floor)
    walk = [t for t in range(len(own)) if (own[t] or glob) and (
        floor is None or bool((floor[t] != raster_resolve.MISS_KEY).any()))]
    assert int(counter) - before == sum(len(own[t]) + len(glob)
                                        for t in walk)
    want = _pallas(b, tile, g0, floor=pfloor)
    np.testing.assert_array_equal(_as_pallas_keys(got, b, g0).numpy(), want)
    assert (got != raster_resolve.MISS_KEY).float().mean() > 0.03
    if scene == "overflow" and not peel:
        # faces of both lists win somewhere, and own slots past the old cut
        pos = got[got != raster_resolve.MISS_KEY] & 0xFFFFFFFF
        assert bool((pos >= b.big_base).any())
        slot = _as_pallas_keys(got, b, g0)[got != raster_resolve.MISS_KEY] \
            & 1023
        assert bool(((slot >= 32) & (slot < g0)).any())
    # a walk that stops halfway along each list must show: the check can
    # fail (the second half of each list pointed at the zero row)
    cut = b._replace(faces=b.faces.clone())
    st = b.starts.tolist()
    for t in range(len(own)):
        cut.faces[(st[t] + st[t + 1]) // 2:st[t + 1]] = b.rows.shape[0] - 1
    assert not torch.equal(_resolve(cut, tile, floor=floor), got)


def test_unpack_keys_matches_jax():
    from d3human_tpu.ops.pallas_raster import unpack_keys as jax_unpack

    b = _binned_rows(seed=4)
    g0 = max(map(len, _lists(b)[0]))
    keys = _resolve(b, (8, 32))
    tri, z = raster_resolve.unpack_keys(keys, b.faces)
    slots = _slot_matrix(b, g0).clamp(max=59)
    jt, jz = jax_unpack(jnp.asarray(_as_pallas_keys(keys, b, g0).numpy()),
                        jnp.asarray(slots.numpy()))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
