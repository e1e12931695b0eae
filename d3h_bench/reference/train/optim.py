"""Per-group Adam of the init, split and seq stages (counterpart of
``d3human_tpu/train/optim.py``): the reference's LambdaLR schedule (linear
warmup, then 10^(-(it - warmup) * 2e-4)), per-stage learning-rate groups of
the geometry leaves with optional per-group global-norm clipping, and the
gradient pre-scaling of the hash tables and the light.

Geometry groups by name (ref train.py:599-614 and :895-901):
  init   ``deform`` x1, ``sdf_net`` x sdf_lr_mult, ``msdf`` and the
         nonrigid MLPs frozen, other leaves x1e-3;
  split  ``deform`` x1, ``msdf`` x1, nonrigid x1e-3, ``sdf_net`` frozen,
         other leaves x1e-2;
  seq    the nonrigid MLPs and ``cond``-named leaves x1e-2 (``fix_code``
         is not one), everything else frozen, the pose too (ref
         train.py:1296-1304).
The pose tensors run at lr_pos * 1e-3 (init and split), the material at
lr_mat with its hash-table gradients times ``hashgrid_grad_scale``, the
light at lr_lgt with its gradient times ``light_grad_scale``; none of the
three is clipped. A frozen leaf gets no update at all.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch


def lr_schedule(base_lr: float, warmup_iter: int, step: int) -> float:
    """ref train.py:573-576."""
    if step < warmup_iter:
        return base_lr * step / max(warmup_iter, 1)
    return base_lr * max(10.0 ** (-(step - warmup_iter) * 0.0002), 0.0)


def resolve_lrs(learning_rate, pass_idx: int = 0) -> Tuple[float, float,
                                                           float]:
    """(pos, mat, lgt) as the JAX package decomposes them: a list is first
    indexed by pass, so f3c's (0.03, 0.005) gives pos = mat = 0.03."""
    lr = learning_rate
    if isinstance(lr, (list, tuple)):
        lr = lr[pass_idx] if pass_idx < len(lr) else lr[-1]
    if isinstance(lr, (list, tuple)):
        lr_pos = lr[0]
        lr_mat = lr[1] if len(lr) > 1 else lr[0]
        lr_lgt = lr[2] if len(lr) > 2 else lr[0] * 6.0
    else:
        lr_pos = lr_mat = lr
        lr_lgt = lr * 6.0
    return float(lr_pos), float(lr_mat), float(lr_lgt)


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str,
                                                            torch.Tensor]]:
    """(path, tensor) over nested dicts/lists, paths like
    ``geometry/sdf_net/layers/0/w``."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}/{i}")


def geometry_label(stage: str, path: str) -> str:
    """LR group of a geometry parameter path in ``stage``."""
    if stage == "init":
        if "deform" in path and "nonrigid" not in path:
            return "x1"
        if "sdf_net" in path:
            return "xsdf"
        if "msdf" in path or "nonrigid" in path:
            return "frozen"
        return "x1e-3"
    if stage == "split":
        if "deform" in path and "nonrigid" not in path:
            return "x1"
        if "msdf" in path:
            return "x1"
        if "nonrigid" in path:
            return "x1e-3"
        if "sdf_net" in path:
            return "frozen"
        return "x1e-2"
    if stage == "seq":
        if "nonrigid" in path:
            return "x1e-2"
        if "cond" in path and "fix_code" not in path:
            return "x1e-2"
        return "frozen"
    raise ValueError(f"stage {stage!r}: the port has the init, split and "
                     "seq stages")


def param_label(stage: str, path: str) -> str:
    top = path.split("/", 1)[0]
    if top == "pose" and stage == "seq":
        return "frozen"
    if top in ("pose", "material", "light"):
        return top
    if top == "geometry":
        return geometry_label(stage, path)
    return "frozen"


class StageAdam:
    """Adam(b1=0.9, b2=0.999, eps=1e-8) per group, with the learning rate
    of the group's schedule at the step count before the update (0 at step
    0) and bias correction at the count after it, as optax does.

    A leaf whose gradient is missing counts as a zero gradient. While such
    a leaf has no moments yet, Adam's update of it is exactly zero, so it
    is skipped and allocates nothing (the light under albedo-only shading,
    the material in the unshaded init step)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, stage: str, params: dict, lr_pos: float,
                 lr_mat: float, lr_lgt: float, warmup_iter: int,
                 clip_max_norm: float = 0.0, sdf_lr_mult: float = 1e-2,
                 hashgrid_grad_scale: float = 0.125,
                 light_grad_scale: float = 64.0):
        geo = {"x1": 1.0, "xsdf": sdf_lr_mult, "x1e-2": 1e-2, "x1e-3": 1e-3}
        self.groups: Dict[str, dict] = {
            name: {"lr": lr_pos * m, "paths": [], "clip": clip_max_norm}
            for name, m in geo.items()}
        self.groups["pose"] = {"lr": lr_pos * 1e-3, "paths": [], "clip": 0.0}
        self.groups["material"] = {"lr": lr_mat, "paths": [], "clip": 0.0}
        self.groups["light"] = {"lr": lr_lgt, "paths": [], "clip": 0.0}
        self.grad_scale: Dict[str, float] = {}
        for path, t in named_leaves(params):
            label = param_label(stage, path)
            if label == "frozen" or not t.is_floating_point():
                continue
            self.groups[label]["paths"].append(path)
            if label == "material" and "table" in path:
                self.grad_scale[path] = hashgrid_grad_scale
            elif label == "light":
                self.grad_scale[path] = light_grad_scale
        self.stage = stage
        self.warmup_iter = warmup_iter
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    def trainable_paths(self) -> List[str]:
        return [p for g in self.groups.values() for p in g["paths"]]

    def _scaled_grad(self, path, grad, leaf):
        if grad is None:
            return torch.zeros_like(leaf)
        scale = self.grad_scale.get(path)
        return grad if scale is None else grad * scale

    @torch.no_grad()
    def step(self, params: dict, grads: Dict[str, Optional[torch.Tensor]]
             ) -> None:
        """Update ``params`` in place from ``grads`` (path -> gradient)."""
        leaves = dict(named_leaves(params))
        t = self.count + 1
        bc1, bc2 = 1.0 - self.B1 ** t, 1.0 - self.B2 ** t
        for g in self.groups.values():
            paths = [p for p in g["paths"]
                     if grads.get(p) is not None or p in self.mu]
            if not paths:
                continue
            gs = [self._scaled_grad(p, grads.get(p), leaves[p])
                  for p in paths]
            if g["clip"] > 0:
                norm = torch.sqrt(sum((x * x).sum() for x in gs))
                keep = norm < g["clip"]
                gs = [torch.where(keep, x, x / norm * g["clip"]) for x in gs]
            lr = lr_schedule(g["lr"], self.warmup_iter, self.count)
            for p, x in zip(paths, gs):
                mu = self.mu.get(p)
                if mu is None:
                    mu = self.mu[p] = torch.zeros_like(x)
                    self.nu[p] = torch.zeros_like(x)
                nu = self.nu[p]
                mu.mul_(self.B1).add_(x, alpha=1.0 - self.B1)
                nu.mul_(self.B2).addcmul_(x, x, value=1.0 - self.B2)
                upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
                leaves[p].sub_(upd * lr)
        self.count += 1
