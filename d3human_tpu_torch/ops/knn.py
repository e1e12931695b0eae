"""Nearest neighbour (K=1) by blocked all-pairs squared distances.

Counterpart of ``d3human_tpu/ops/knn.py`` for the K=1 case of the
skinning-weight transfer and the cloth-body collision loss. Distances are
(|q|^2 + |r|^2) - 2 q.r in the JAX package's order of operations. The
reference set is walked in blocks of ``block`` points with a running
minimum, as the JAX package's scan does, and the queries in blocks sized so
that one distance block holds at most ``SCRATCH_ELEMS`` floats: the
scratch is bounded whatever the two set sizes are. On exact ties the lower
reference index wins, as in the JAX package's top-k merge. The returned
squared distances are recomputed differentiably from the winners.
"""

from __future__ import annotations

from typing import Tuple

import torch

SCRATCH_ELEMS = 1 << 28   # floats of one [query block, reference block]


def knn1(query: torch.Tensor, ref: torch.Tensor,
         block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sq_dists [P], idx [P] int64) of each query's nearest ref point."""
    P, M = query.shape[0], ref.shape[0]
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
