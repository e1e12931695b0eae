"""Row scatter-add and row gathers, plain PyTorch (``index_add`` and
indexing, whose backward PyTorch derives).

``coo_scatter_add(idx, vals, out_rows)`` is
``zeros((out_rows, C)).at[idx].add(vals)`` with the rows whose idx lies
outside ``[0, out_rows)`` dropped."""

from __future__ import annotations

import torch


def _add(vals: torch.Tensor, idx: torch.Tensor, out_rows: int):
    idx = idx.reshape(-1).long()
    dest = torch.where((idx >= 0) & (idx < out_rows), idx, out_rows)
    out = torch.zeros((out_rows + 1,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    return out.index_add(0, dest, vals)[:out_rows]


def coo_scatter_add(idx: torch.Tensor, vals: torch.Tensor, out_rows: int,
                    sorted_idx: bool = False) -> torch.Tensor:
    """[N] int destinations + [N, C] values -> [out_rows, C]."""
    return _add(vals, idx, out_rows)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx], idx in [0, rows)."""
    return table[idx.long()]


def segment_add_rows(vals: torch.Tensor, idx: torch.Tensor,
                     out_rows: int) -> torch.Tensor:
    """Differentiable zeros((out_rows, C)).at[idx].add(vals)."""
    return _add(vals, idx, out_rows)


def scatter_rows_sorted(vals: torch.Tensor, idx: torch.Tensor,
                        out_rows: int) -> torch.Tensor:
    """zeros((out_rows, C)).at[idx].set(vals) for unique idx."""
    return _add(vals, idx, out_rows)
