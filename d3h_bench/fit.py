"""A fit cell: the port's SDF pretraining (``GeometryModel.pretrain_sdf``,
full-batch Adam of the SDF MLP at every grid vertex, run
``stages.sdf_mlp_pretrain_steps`` times a subject) as the timed call.

The window calls ``pretrain_sdf`` again and again, ``steps_per_call``
Adam steps a call, each call going on from the last one's layers (a call
starts its own Adam, as the program's single call does). The first call
is observed for ``correct``: the loss of each of its first
``CHECK_STEPS`` steps as the program computes it, each leaf's first moment
after the first step (the gradient as the optimizer got it), and each
leaf after ``CHECK_STEPS`` steps."""

from __future__ import annotations

import contextlib
import types
from typing import Dict, Optional

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from d3h_bench import check
from d3h_bench.loop import Loop
from d3h_bench.reference.train.fit import leaf_names


class FitLoop(Loop):
    """Calls of the port's ``pretrain_sdf`` on one set of layers; ``it``
    counts Adam steps, ``totals`` each call's last loss (a host float, as
    the call returns it)."""

    def __init__(self, geo, params: dict, target: torch.Tensor,
                 steps_per_call: int, lr: float, device):
        super().__init__(None, None, None, 0, device, 1)
        self.geo = geo
        self.params = params
        self.target = target
        self.steps_per_call = steps_per_call
        self.lr = lr

    def step(self, dispatch: Optional[list] = None) -> dict:
        self.params, loss = self.geo.pretrain_sdf(
            self.params, self.target, steps=self.steps_per_call, lr=self.lr)
        self.totals.append(torch.tensor(loss))
        self.it += self.steps_per_call
        return {"total": self.totals[-1]}


@contextlib.contextmanager
def observed(geo, rec: check.Record, start: Dict[str, torch.Tensor],
             n: int = check.CHECK_STEPS):
    """Record into ``rec`` the first ``n`` steps of the next call of
    ``geo.pretrain_sdf`` (``start``: the layers it starts from, on the
    host)."""
    losses, seen = [], {"steps": 0}
    inner = geo._fit

    def fit(net, loss_fn, steps, lr):
        names = leaf_names(net)

        def observed_loss(layers):
            loss = loss_fn(layers)
            if len(losses) < n:
                losses.append(loss.detach().clone())
            return loss

        def after_step(opt, args, kwargs):
            seen["steps"] += 1
            ps = opt.param_groups[0]["params"]
            if seen["steps"] == 1:
                rec.grad = {name: float(torch.linalg.vector_norm(
                    opt.state[p]["exp_avg"])) if p in opt.state else 0.0
                    for name, p in zip(names, ps)}
            if seen["steps"] == n:
                rec.change = {name: float(torch.linalg.vector_norm(
                    p.detach().cpu() - start[name])) for name, p in
                    zip(names, ps)}

        handle = register_optimizer_step_post_hook(after_step)
        try:
            return inner(net, observed_loss, steps, lr)
        finally:
            handle.remove()

    geo._fit = fit
    try:
        yield
    finally:
        del geo._fit
        rec.losses = [float(t) for t in losses]


def fault(geo, name: str):
    """Break the port's fit underneath (the check's own tests); returns
    the call that undoes it."""
    adam = torch.optim.Adam
    inner_step = adam.step
    if name in ("stale_state", "half_gradient"):
        def step(self, closure=None):
            if name == "stale_state":
                return None
            for i, p in enumerate(self.param_groups[0]["params"]):
                if i % 2 == 0:
                    p.grad = None
            return inner_step(self, closure)

        adam.step = step
        return lambda: setattr(adam, "step", inner_step)
    if name == "altered_loss":
        inner_fit = geo._fit

        def fit(net, loss_fn, steps, lr):
            return inner_fit(net, lambda layers: loss_fn(layers) * 1.01,
                             steps, lr)

        geo._fit = fit
        return lambda: setattr(geo, "_fit", inner_fit)
    if name == "half_batch":
        inner_call = geo.pretrain_sdf

        def pretrain_sdf(params, target, steps, lr=1e-3):
            grid, half = geo.grid, target.shape[0] // 2
            geo.grid = types.SimpleNamespace(verts=grid.verts[:half])
            try:
                return inner_call(params, target[:half], steps, lr)
            finally:
                geo.grid = grid

        geo.pretrain_sdf = pretrain_sdf
        return lambda: delattr(geo, "pretrain_sdf")
    raise ValueError(f"fault {name!r}")


def reference_record(inputs, device) -> check.Record:
    """The reference's first ``CHECK_STEPS`` steps from the same layers."""
    from d3h_bench.reference.train.fit import fit as ref_fit

    start = {n: t.detach().cpu() for n, t in zip(
        leaf_names(inputs.params["sdf_net"]),
        (lay[k] for lay in inputs.params["sdf_net"]["layers"]
         for k in ("w", "b")))}
    losses, first, after = ref_fit(inputs, check.CHECK_STEPS, device)
    rec = check.Record()
    rec.losses = losses
    rec.grad = {n: float(torch.linalg.vector_norm(t))
                for n, t in first.items()}
    rec.change = {n: float(torch.linalg.vector_norm(
        after[n].cpu() - start[n])) for n in after}
    return rec
