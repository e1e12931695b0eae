"""What decides ``correct``: the port's first ``CHECK_STEPS`` steps, taken
through the window's own loop, against the plain reference
(``reference/``) run after the window from the same initial parameters,
targets and generators.

The numbers, each held to the cell's limit where the cell's
``workloads/<cell>.json`` ``"limits"`` names it:

- ``loss_gap``: the largest relative gap of a step's total loss;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as the optimizer got it (Adam's first moment after one step),
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger;
- ``change_gap``: the same of each leaf's change over the three steps,
  over the leaves whose reference gradient is at least ``MOVED`` of the
  median leaf's (a leaf with no gradient moves by round-off alone)."""

from __future__ import annotations

import gc
import math
from typing import Dict, Iterable

import torch

CHECK_STEPS = 3
MOVED = 1e-3


def leaves(tree, prefix: str = ""):
    """(path, tensor) over nested dicts and lists."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {p: float(torch.linalg.vector_norm(t.float())) for p, t in d.items()}


class Record:
    """What one side produced in its first steps: each step's loss, each
    leaf's first-moment norm after the first step, each leaf's change."""

    def __init__(self):
        self.losses = []
        self.grad = {}
        self.change = {}

    def take(self, loop, start: dict) -> None:
        """Run ``CHECK_STEPS`` steps of ``loop`` (whose state holds the
        parameters ``start``, a host copy) and record them."""
        for i in range(CHECK_STEPS):
            loop.step()
            if i == 0:
                self.grad = _norms(loop.state.opt.mu)
        now = dict(leaves(loop.state.params))
        self.change = {p: float(torch.linalg.vector_norm(
            now[p].detach().cpu().float() - start[p].float()))
            for p in start}
        self.losses = [float(t) for t in loop.totals[-CHECK_STEPS:]]


def _worst(xs: Iterable[float]) -> float:
    """The largest of ``xs`` (0 for none); inf where one is not finite."""
    xs = list(xs)
    if not all(math.isfinite(x) for x in xs):
        return float("inf")
    return max(xs, default=0.0)


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               paths) -> Dict[str, float]:
    """Each leaf's gap between the two sides' norms, over the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    paths = list(paths)
    vals = sorted(ref[p] for p in paths)
    med = vals[len(vals) // 2] if vals else 0.0
    return {p: abs(prog.get(p, 0.0) - ref[p]) / max(ref[p], med, 1e-30)
            for p in paths}


def _median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else 0.0


def gaps(prog: Record, ref: Record) -> Dict[str, float]:
    """The numbers of the module docstring, and beside them the steadier
    ones a cell may compare instead: ``loss_gap_first`` (the first step's
    loss alone), ``grad_gap_median`` and ``change_gap_median`` (the median
    leaf's gap in place of the worst)."""
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(prog.losses, ref.losses)]
    loss = _worst(rel)
    if len(prog.losses) != len(ref.losses) or not rel:
        loss = float("inf")
        rel = [loss]
    med = _median(ref.grad.values())
    g = _leaf_gaps(prog.grad, ref.grad, ref.grad)
    grad = _worst(g.values())
    if any(prog.grad[p] > MOVED * med for p in set(prog.grad) - set(ref.grad)):
        grad = float("inf")
    moved = [p for p, v in ref.grad.items() if v >= MOVED * med]
    c = _leaf_gaps(prog.change, ref.change, moved)
    out = {"loss_gap": loss, "grad_gap": grad, "change_gap": _worst(c.values()),
           "loss_gap_first": _worst(rel[:1]),
           "grad_gap_median": _median(g.values()) if math.isfinite(grad)
           else grad,
           "change_gap_median": _median(c.values())}
    worst = {"grad": max(g, key=g.get, default=None),
             "change": max(c, key=c.get, default=None)}
    return out, worst


def reference_record(inputs, start: dict, device,
                     raster_opts=None) -> Record:
    """The reference's first steps on ``inputs`` from ``start``
    (``raster_opts`` to its rasterizer)."""
    from d3h_bench.loop import Loop
    from d3h_bench.reference import model as ref_model

    state, step_fn = ref_model.build(inputs, device, raster_opts)
    loop = Loop(step_fn, state, ref_model.target_fn(inputs),
                inputs.seeds["stage"], device,
                inputs.cfg.stages.log_interval)
    rec = Record()
    rec.take(loop, start)
    del loop, state, step_fn
    gc.collect()
    return rec


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the cell's ``limits`` name within its limit."""
    return bool(limits) and all(
        math.isfinite(values[k]) and values[k] <= lim
        for k, lim in limits.items())
