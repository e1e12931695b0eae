"""Nearest neighbours by blocked all-pairs squared distances.

Counterpart of ``d3human_tpu/ops/knn.py``: ``knn1`` is the K=1 case of the
skinning-weight transfer and the cloth-body collision loss, ``knn`` the
K-nearest search of the mesh SDF. Distances are (|q|^2 + |r|^2) - 2 q.r in
the JAX package's order of operations. The reference set is walked in
blocks of ``block`` points with a running minimum (``knn1``) or a running
top-k (``knn``), as the JAX package's scan does, and the queries in blocks
sized so that one distance block holds at most ``SCRATCH_ELEMS`` floats:
the scratch is bounded whatever the two set sizes are. On exact ties the
lower reference index wins, as in the JAX package's top-k merge. The
returned squared distances are recomputed differentiably from the winners.

``pair_counts()`` reads the (query, reference) pairs each search has
compared since ``reset_pair_counts()``: plain host integers, P x M a call
from the shapes, with no device read.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from d3human_tpu_torch.ops.scatter import gather_rows

SCRATCH_ELEMS = 1 << 28   # floats of one [query block, reference block]

_PAIRS = {"knn1": 0, "knn": 0}


def pair_counts() -> Dict[str, int]:
    """Pairs compared by ``knn1`` and by ``knn`` since the last reset."""
    return dict(_PAIRS)


def reset_pair_counts() -> None:
    for k in _PAIRS:
        _PAIRS[k] = 0


def knn1(query: torch.Tensor, ref: torch.Tensor,
         block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sq_dists [P], idx [P] int64) of each query's nearest ref point."""
    P, M = query.shape[0], ref.shape[0]
    _PAIRS["knn1"] += P * M
    dev = query.device
    block = max(1, min(block, M))
    q_block = max(1, SCRATCH_ELEMS // block)
    q_all, r_all = query.detach(), ref.detach()
    r2_all = (r_all * r_all).sum(-1)
    idx = torch.zeros((P,), dtype=torch.int64, device=dev)
    for s in range(0, P, q_block):
        q = q_all[s:s + q_block]
        q2 = (q * q).sum(-1, keepdim=True)
        best_d = torch.full((q.shape[0],), float("inf"), dtype=q.dtype,
                            device=dev)
        best_i = torch.zeros((q.shape[0],), dtype=torch.int64, device=dev)
        for b in range(0, M, block):
            r = r_all[b:b + block]
            d = q2 + r2_all[b:b + block][None, :]
            d.addmm_(q, r.T, alpha=-2.0)
            d_min, i_min = torch.min(d, dim=1)
            better = d_min < best_d
            best_d = torch.where(better, d_min, best_d)
            best_i = torch.where(better, i_min + b, best_i)
        idx[s:s + q_block] = best_i
    diff = query - ref[idx]
    return (diff * diff).sum(-1), idx


def knn(query: torch.Tensor, ref: torch.Tensor, k: int = 1,
        ref_valid: Optional[torch.Tensor] = None,
        block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sq_dists [P, k], idx [P, k] int64) of each query's k nearest refs,
    nearest first. Refs where ``ref_valid`` [M] is false are at +inf; a
    query with fewer than k valid refs gets +inf and index 0 in the
    remaining places. Each block's candidates merge into the running best
    by a stable sort of [best | block], so equal distances keep the lower
    index first (the JAX package's ``lax.top_k`` order). The distances'
    backward is the scatter kernel (``gather_rows``)."""
    P, M = query.shape[0], ref.shape[0]
    _PAIRS["knn"] += P * M
    dev = query.device
    block = max(1, min(block, M))
    q_block = max(1, SCRATCH_ELEMS // (block + k))
    q_all, r_all = query.detach(), ref.detach()
    r2_all = (r_all * r_all).sum(-1)
    best_all = torch.empty((P, k), dtype=query.dtype, device=dev)
    idx = torch.empty((P, k), dtype=torch.int64, device=dev)
    for s in range(0, P, q_block):
        q = q_all[s:s + q_block]
        q2 = (q * q).sum(-1, keepdim=True)
        best_d = torch.full((q.shape[0], k), float("inf"), dtype=q.dtype,
                            device=dev)
        best_i = torch.zeros((q.shape[0], k), dtype=torch.int64, device=dev)
        for b in range(0, M, block):
            r = r_all[b:b + block]
            d = q2 + r2_all[b:b + block][None, :]
            d.addmm_(q, r.T, alpha=-2.0)
            if ref_valid is not None:
                d = torch.where(ref_valid[b:b + block][None, :], d,
                                float("inf"))
            sd, order = torch.sort(torch.cat([best_d, d], dim=1), dim=1,
                                   stable=True)
            best_d, win = sd[:, :k], order[:, :k]
            # a winner below k is a running best, else block column win - k
            best_i = torch.where(
                win < k, torch.gather(best_i, 1, win.clamp(max=k - 1)),
                win + (b - k))
        best_all[s:s + q_block] = best_d
        idx[s:s + q_block] = best_i
    nn = gather_rows(ref, idx.clamp(0, M - 1))                # [P, k, 3]
    diff = query[:, None, :] - nn
    sq = (diff * diff).sum(-1)
    return torch.where(torch.isfinite(best_all), sq, float("inf")), idx


def knn_gather(ref_attrs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-neighbour attributes: ref_attrs [M, C], idx [P, k] -> [P, k, C]
    (the scatter kernel in the backward)."""
    return gather_rows(ref_attrs, idx)
