"""The reference's side of a fit cell: the SDF MLP fitted at the grid's
vertices to the target SDF by full-batch Adam, the Adam update written
out (ref hmsdf.py:251-273, ``torch.optim.Adam``'s defaults: betas 0.9 and
0.999, eps 1e-8, no weight decay)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from d3h_bench.inputs import FitInputs, to_device

BETAS = (0.9, 0.999)
EPS = 1e-8


def leaf_names(net: dict, prefix: str = "sdf_net") -> List[str]:
    """The layers' leaves in the fit's order: each layer's w, then b."""
    return [f"{prefix}/layers/{i}/{k}" for i in range(len(net["layers"]))
            for k in ("w", "b")]


def grid_verts(inputs: FitInputs, device) -> torch.Tensor:
    """The grid's vertices, read by the reference's own tet-grid code."""
    from d3h_bench.reference.ops import tet_grid

    if inputs.lattice is None:
        grid = tet_grid.load_reference_tet_grid(inputs.grid_file,
                                                device=device)
    else:
        grid = tet_grid.make_tet_grid(**inputs.lattice, device=device,
                                      cache_path=inputs.grid_file)
    return grid.verts


def fit(inputs: FitInputs, steps: int, device
        ) -> Tuple[List[float], Dict[str, torch.Tensor],
                   Dict[str, torch.Tensor]]:
    """(each step's loss before its update, each leaf's first moment after
    the first step, each leaf after ``steps`` steps) from the benchmark's
    initial layers."""
    from d3h_bench.reference.models.fields import MLP

    f = inputs.cfg.field
    mlp = MLP(n_freq=f.n_freq, d_hidden=f.d_hidden, n_hidden=f.n_hidden,
              skip_in=f.skip_in, d_out=1)
    verts = grid_verts(inputs, device)
    tgt = inputs.target.to(device).reshape(-1)
    net = to_device(inputs.params["sdf_net"], device)
    names = leaf_names(net)
    p = [lay[k].detach().clone().requires_grad_(True)
         for lay in net["layers"] for k in ("w", "b")]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    b1, b2 = BETAS
    losses, first = [], {}
    for t in range(1, steps + 1):
        layers = {"layers": [{"w": p[2 * i], "b": p[2 * i + 1]}
                             for i in range(len(p) // 2)]}
        loss = ((mlp.apply(layers, verts)[..., 0] - tgt) ** 2).mean()
        grads = torch.autograd.grad(loss, p)
        with torch.no_grad():
            for i, g in enumerate(grads):
                m[i] = b1 * m[i] + (1.0 - b1) * g
                v[i] = b2 * v[i] + (1.0 - b2) * g * g
                m_hat = m[i] / (1.0 - b1 ** t)
                v_hat = v[i] / (1.0 - b2 ** t)
                p[i] -= inputs.lr * m_hat / (torch.sqrt(v_hat) + EPS)
        losses.append(float(loss.detach()))
        if t == 1:
            first = {n: mi.clone() for n, mi in zip(names, m)}
    return losses, first, {n: t.detach() for n, t in zip(names, p)}
