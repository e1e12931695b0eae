"""Sorted-COO scatter-add and the autograd Functions built on it.

Counterpart of ``d3human_tpu/ops/scatter.py``. ``coo_scatter_add`` is
``zeros((out_rows, C)).at[idx].add(vals)`` where rows whose idx lies outside
``[0, out_rows)`` — negatives included — are dropped; ``sorted_idx=True``
skips the sort for already-ascending indices.

On a CUDA tensor the wrapper makes one call into ``csrc/scatter.cu``: one
hand-written pass that writes int32 keys and an int32 iota, a stable radix
sort over the key bits that can be set, then the hand-written deterministic
tiled segmented sum (two launches per call), which replaces the Pallas
kernel ``d3human_tpu/ops/scatter.py:41 _scatter_kernel``; the source note
there says what bounds it. On a CPU tensor it runs
``coo_scatter_add_plain``, which adds the same sorted rows in the same order.

``gather_rows``, ``segment_add_rows`` and ``scatter_rows_sorted`` are
``torch.autograd.Function``s with the VJPs of the JAX package's custom VJPs
(``scatter.py:157-238``): the backward of a row gather is this scatter.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from d3human_tpu_torch.ops import cuda_lib

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {
    "d3h_sort_scratch_bytes": (_LL, _INT,
                               ctypes.POINTER(ctypes.c_ulonglong)),
    "d3h_coo_scatter_add": (_PTR, _INT, _PTR, _LL, _INT, _INT, _INT, _INT,
                            _PTR, ctypes.c_ulonglong, _PTR, _PTR),
}
# the constants of csrc/scatter.cu
THREADS = 256   # threads of a CTA
TILE = 1024     # sorted rows per CTA of the tile kernel
COLS = 16       # columns per CTA
CHUNK = 16      # entries per thread in the shared-memory levels
NONE = 2 ** 31 - 1      # key of an entry that carries nothing


def _launches(n: int) -> int:
    """Launches of the sum kernels for n sorted rows: the tile kernel, and
    the carry kernel when there is more than one tile."""
    return 0 if n == 0 else 1 if n <= TILE else 2


def sort_rows_plain(idx: torch.Tensor, out_rows: int, sorted_idx: bool):
    """(sorted int32 keys, int32 permutation or None when ``sorted_idx``).
    Out-of-range rows get the sentinel key ``out_rows`` before the stable
    sort, so negatives do not land at the front."""
    idx = idx.reshape(-1)
    keys = torch.where((idx >= 0) & (idx < out_rows), idx,
                       out_rows).to(torch.int32)
    if sorted_idx:
        return keys, None
    keys, perm = torch.sort(keys, stable=True)
    return keys, perm.to(torch.int32)


@functools.lru_cache(maxsize=256)
def _sort_scratch_bytes(n: int, bits: int) -> int:
    """Bytes of scratch the radix sort of n pairs wants (a host-side query)."""
    size = ctypes.c_ulonglong(0)
    cuda_lib.check(cuda_lib.load("scatter", _SIG).d3h_sort_scratch_bytes(
        n, bits, ctypes.byref(size)), "sort_scratch_bytes")
    return max(size.value, 1)


def _key_bits(out_rows: int) -> int:
    """The bits a key can set: the largest key is the sentinel out_rows."""
    return max(out_rows.bit_length(), 1)


def _aligned(vals: torch.Tensor) -> torch.Tensor:
    """Contiguous, and on a 16-byte line: the kernel loads 16 bytes at once."""
    vals = vals.contiguous()
    return vals.clone() if vals.data_ptr() % 16 else vals


def _int_idx(idx: torch.Tensor) -> torch.Tensor:
    idx = idx.reshape(-1)
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.long()
    return idx.contiguous()


def _pieces(length: int, block: int, piece: int, npieces: int, device):
    """(starts, ends) of ``npieces`` pieces of ``piece`` entries in every
    block of ``block`` entries of a list of ``length``; a piece past its
    block's end is empty (start == end)."""
    nblocks = -(-length // block)
    b0 = torch.arange(nblocks, device=device)[:, None] * block
    lim = (b0 + block).clamp(max=length)
    s = b0 + torch.arange(npieces, device=device)[None, :] * piece
    e = torch.minimum(s + piece, lim)
    return torch.minimum(s, e).reshape(-1), e.reshape(-1)


def _segsum_level(keys, vals, out, starts, ends, steps: int):
    """One level of the kernel's segmented sum, for all pieces at once: each
    piece adds its entries in order; a run inside a piece goes to ``out``
    (its last row absorbs sentinels), the parts of runs that cross a piece's
    edge come back as the next level's (keys [2 * pieces], vals), with key
    NONE where nothing crosses."""
    n = keys.shape[0]
    empty = starts >= ends
    s = starts.clamp(max=n - 1)
    last = (ends - 1).clamp(min=0)
    pos = s[:, None] + torch.arange(steps, device=keys.device)[None, :]
    inside = pos < ends[:, None]
    pos = torch.minimum(pos, last[:, None])
    k = keys[pos]                       # past the end: the last key again
    v = torch.where(inside[..., None], vals[pos], 0.0)
    cont_in = ~empty & (starts > 0) & (keys[(s - 1).clamp(min=0)] == keys[s])
    cont_out = ~empty & (ends < n) & (keys[ends.clamp(max=n - 1)]
                                      == keys[last])
    new = torch.ones_like(k, dtype=torch.bool)
    new[:, 1:] = k[:, 1:] != k[:, :-1]
    fin = torch.ones_like(new)
    fin[:, :-1] = new[:, 1:]
    out_rows = out.shape[0] - 1
    first = torch.ones_like(cont_in)
    acc = vals.new_zeros((starts.shape[0], vals.shape[1]))
    head, tail = torch.zeros_like(acc), torch.zeros_like(acc)
    for j in range(steps):
        if j:
            first = first & ~new[:, j]
            acc = torch.where(new[:, j, None], 0.0, acc)
        acc = acc + v[:, j]
        is_head = fin[:, j] & first & cont_in
        done = fin[:, j] & ~is_head & ~empty
        if j == steps - 1:
            is_tail = fin[:, j] & cont_out
            is_head = is_head & ~is_tail
            done = done & ~is_tail
            tail = torch.where(is_tail[:, None], acc, tail)
        head = torch.where(is_head[:, None], acc, head)
        dest = torch.where(done & (k[:, j] < out_rows), k[:, j], out_rows)
        out.index_put_((dest.long(),), acc, accumulate=True)
    none = torch.full_like(keys[s], NONE)
    next_keys = torch.stack([torch.where(cont_in, keys[s], none),
                             torch.where(cont_out, keys[last], none)], 1)
    return next_keys.reshape(-1), torch.stack([head, tail], 1).reshape(
        -1, vals.shape[1])


def _segsum_launch(keys, vals, out, tile: int):
    """One launch of the sum kernel over ``vals`` [n, <= COLS]: every tile
    of ``tile`` rows is cut into one piece per thread group, then the
    crossing parts are reduced in chunks of CHUNK until two are left per
    tile. Returns those (keys, vals [2 * tiles, C])."""
    groups = THREADS // -(-vals.shape[1] // 4)
    dev = keys.device
    r = -(-tile // groups)
    keys, vals = _segsum_level(
        keys, vals, out, *_pieces(keys.shape[0], tile, r, groups, dev), r)
    e = 2 * groups
    while True:
        chunks = -(-e // CHUNK)
        keys, vals = _segsum_level(
            keys, vals, out, *_pieces(keys.shape[0], e, CHUNK, chunks, dev),
            CHUNK)
        if chunks == 1:
            return keys, vals
        e = 2 * chunks


def segmented_sum_plain(keys: torch.Tensor, perm, vals: torch.Tensor,
                        out_rows: int) -> torch.Tensor:
    """Sorted int32 ``keys`` [N] (a key >= out_rows drops its row), the
    sort's ``perm`` (None: ``vals`` are in key order), ``vals`` [N, C] ->
    [out_rows, C] sums of the runs of equal keys: the sum kernels' launches
    and levels with every addition in their order."""
    v = vals if perm is None else vals[perm.long()]
    out = torch.zeros((out_rows + 1, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    n = keys.shape[0]
    for c0 in range(0, vals.shape[1] if n else 0, COLS):
        ob = out[:, c0:c0 + COLS]
        ck, cv = _segsum_launch(keys, v[:, c0:c0 + COLS], ob, TILE)
        if n > TILE:
            _segsum_launch(ck, cv, ob, ck.shape[0])
    return out[:out_rows]


def coo_scatter_add_plain(idx: torch.Tensor, vals: torch.Tensor,
                          out_rows: int, sorted_idx: bool = False
                          ) -> torch.Tensor:
    """Plain PyTorch version: a stable sort by destination, then
    ``segmented_sum_plain``."""
    keys, perm = sort_rows_plain(idx, out_rows, sorted_idx)
    return segmented_sum_plain(keys, perm, vals, out_rows)


@cuda_lib.counted("scatter", _SIG)
def coo_scatter_add(idx: torch.Tensor, vals: torch.Tensor, out_rows: int,
                    sorted_idx: bool = False) -> torch.Tensor:
    """[N] int destinations + [N, C] f32 values -> [out_rows, C] f32."""
    if vals.dim() != 2:
        raise ValueError(f"coo_scatter_add: vals must be [N, C], got "
                         f"{tuple(vals.shape)}")
    if vals.device.type == "cpu":
        return coo_scatter_add_plain(idx, vals, out_rows, sorted_idx)
    if vals.device.type != "cuda" or idx.device != vals.device:
        raise ValueError("coo_scatter_add: idx and vals must be on one "
                         "CUDA device")
    if vals.dtype != torch.float32:
        raise ValueError(f"coo_scatter_add: vals must be float32, got "
                         f"{vals.dtype}")
    if out_rows >= 2 ** 31 - 1 or vals.shape[0] >= 2 ** 31 - 1:
        raise ValueError("coo_scatter_add: out_rows and N must fit int32")
    if idx.numel() != vals.shape[0]:
        raise ValueError(f"coo_scatter_add: {idx.numel()} destinations for "
                         f"{vals.shape[0]} rows")
    N, C = vals.shape
    dev = vals.device
    out = torch.empty((out_rows, C), dtype=torch.float32, device=dev)
    if out_rows == 0 or C == 0:
        return out
    idx = _int_idx(idx)
    vals = _aligned(vals)
    # one scratch tensor for the sort and the carries (its layout:
    # d3h_coo_scatter_add)
    bits = _key_bits(out_rows)
    scratch = 0 if sorted_idx or N == 0 else _sort_scratch_bytes(N, bits)
    tiles = -(-N // TILE)
    words = (0 if sorted_idx else 4 * (N + 3)) + 2 * tiles * (1 + C) + 4
    work = torch.empty((-(-scratch // 256) * 256 + 4 * words,),
                       dtype=torch.uint8, device=dev)
    # counts the launches of the two sum kernels
    cuda_lib.launch(coo_scatter_add, "d3h_coo_scatter_add", idx.data_ptr(),
                    int(idx.dtype == torch.int64), vals.data_ptr(), N, C,
                    out_rows, int(sorted_idx), bits, work.data_ptr(), scratch,
                    out.data_ptr(), device=dev, launches=_launches(N))
    coo_scatter_add.calls += 1
    return out


def _gather_masked(g: torch.Tensor, idx: torch.Tensor,
                   out_rows: int) -> torch.Tensor:
    """g[clip(idx)] with rows of out-of-range idx zeroed (the VJP of a
    scatter that drops them)."""
    ok = (idx >= 0) & (idx < out_rows)
    dv = g[idx.clamp(0, out_rows - 1).long()]
    return torch.where(ok[..., None], dv, torch.zeros((), dtype=g.dtype,
                                                     device=g.device))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx.long()]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat_g = g.reshape(-1, g.shape[-1]).contiguous()
        dt = coo_scatter_add(idx.reshape(-1), flat_g, ctx.rows)
        return dt, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] ([..., C] row gather) whose backward is ``coo_scatter_add``.
    idx must lie in [0, rows): unlike a JAX gather, nothing is clamped."""
    return _GatherRows.apply(table, idx)


class _SegmentAddRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, idx, out_rows):
        ctx.save_for_backward(idx)
        ctx.out_rows = out_rows
        return coo_scatter_add(idx, vals, out_rows)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _gather_masked(g, idx, ctx.out_rows), None, None


def segment_add_rows(vals: torch.Tensor, idx: torch.Tensor,
                     out_rows: int) -> torch.Tensor:
    """Differentiable zeros((out_rows, C)).at[idx].add(vals) (unsorted idx,
    duplicates accumulate, out-of-range rows dropped)."""
    return _SegmentAddRows.apply(vals, idx, out_rows)


class _ScatterRowsSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, idx, out_rows):
        ctx.save_for_backward(idx)
        ctx.out_rows = out_rows
        return coo_scatter_add(idx, vals, out_rows, sorted_idx=True)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _gather_masked(g, idx, ctx.out_rows), None, None


def scatter_rows_sorted(vals: torch.Tensor, idx: torch.Tensor,
                        out_rows: int) -> torch.Tensor:
    """zeros((out_rows, C)).at[idx].set(vals) for sorted unique idx
    (out-of-range rows dropped); unique indices make add == set."""
    return _ScatterRowsSorted.apply(vals, idx, out_rows)
