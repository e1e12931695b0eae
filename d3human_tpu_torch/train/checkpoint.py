"""Checkpoints and the pretraining caches (counterpart of
``d3human_tpu/train/checkpoint.py``).

A parameter tree (nested dicts and lists of tensors) is one npz whose keys
are the JAX package's ``jax.tree_util.keystr`` paths, e.g.
``['geometry']['sdf_net']['layers'][0]['w']``: the port reads a JAX
checkpoint's parameters or a JAX pretraining cache, and JAX reads the
port's. Loading is size-filtered: an entry missing from the file or of
another shape keeps the template's value (ref train.py:284-289).

``save_state`` adds the step and ``StageAdam``'s moments and count under
``['opt']``; that part is the port's own (optax's state tree differs), so
a state file crosses between the packages by its ``['params']`` only.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from d3human_tpu_torch.train.optim import named_leaves
from d3human_tpu_torch.train.step import TrainState
from d3human_tpu_torch.utils.io import host


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(keystr path, leaf) in the JAX package's key format."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def save_params(path: str, params) -> None:
    """One npz of the tree, keyed by keystr paths (uncompressed: the
    states run to hundreds of MB at full width, and ``np.load`` reads
    either form)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: host(v) for k, v in _leaves(params)}
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def _restore(tree, stored: Dict[str, np.ndarray], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _restore(v, stored, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_restore(v, stored, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    a = stored.get(prefix)
    if isinstance(tree, torch.Tensor):
        if a is None or tuple(a.shape) != tuple(tree.shape):
            return tree
        return torch.as_tensor(a).to(device=tree.device, dtype=tree.dtype)
    if a is None or a.shape != np.shape(tree):
        return tree
    return type(tree)(a) if np.ndim(tree) == 0 else a


def load_params(path: str, params_template):
    """The template's tree with every leaf the file holds at the same
    shape read from it (in the template leaf's dtype and device)."""
    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}
    return _restore(params_template, stored)


def save_state(path: str, state: TrainState) -> None:
    """Params, step and the optimizer's count and moments, so that a
    resumed run is bit for bit the uninterrupted one."""
    opt = state.opt
    save_params(path, {"params": state.params, "step": state.step,
                       "opt": {"count": opt.count, "mu": opt.mu,
                               "nu": opt.nu}})


def load_state(path: str, state: TrainState) -> TrainState:
    """Restore a ``save_state`` file into ``state`` (a fresh state of the
    same stage): params size-filtered as in ``load_params``, the moments
    of the stage's trainable leaves the file holds at their shapes."""
    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}
    params = _restore({"params": state.params}, stored)["params"]
    opt = state.opt
    leaves = dict(named_leaves(params))
    opt.mu.clear()
    opt.nu.clear()
    for p in opt.trainable_paths():
        mu = stored.get(f"['opt']['mu'][{p!r}]")
        nu = stored.get(f"['opt']['nu'][{p!r}]")
        if mu is not None and nu is not None \
                and tuple(mu.shape) == tuple(leaves[p].shape):
            opt.mu[p] = torch.as_tensor(mu).to(leaves[p].device)
            opt.nu[p] = torch.as_tensor(nu).to(leaves[p].device)
    opt.count = int(stored["['opt']['count']"])
    return TrainState(params=params, opt=opt,
                      step=int(stored["['step']"]))


def latest_checkpoint(ckpt_dir: str, prefix: str = "state_"
                      ) -> Optional[str]:
    """The ``<prefix><n>.npz`` of ``ckpt_dir`` with the largest n."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [f for f in os.listdir(ckpt_dir)
             if f.startswith(prefix) and f.endswith(".npz")
             and f[len(prefix):-4].isdigit()]
    if not cands:
        return None
    cands.sort(key=lambda f: int(f[len(prefix):-4]))
    return os.path.join(ckpt_dir, cands[-1])


def pretrain_cache_paths(cfg, cache_dir: str = os.path.join("out", "cache"),
                         crop_box=None) -> Tuple[str, str]:
    """(sdf_net cache, nonrigid cache): the JAX package's file names, keyed
    by the lattice (resolution, scale, offset, crop margin and the sha1 of
    the crop box actually applied), the step counts and the seed."""
    g = cfg.geometry
    crop = ""
    if g.grid_crop > 0 or crop_box is not None:
        crop = f"_crop{g.grid_crop:g}"
        if crop_box is not None:
            h = hashlib.sha1(np.asarray(crop_box, np.float64).tobytes()
                             ).hexdigest()[:8]
            crop += f"_b{h}"
    key = f"{g.grid_res}x{g.grid_scale}"
    if g.grid_y_offset:
        key += f"y{g.grid_y_offset:g}"
    pcache = os.path.join(
        cache_dir, f"sdf_pretrain_g{key}{crop}"
        f"_s{cfg.stages.sdf_mlp_pretrain_steps}_seed{cfg.seed}.npz")
    ncache = os.path.join(
        cache_dir, f"nonrigid_zero_s{cfg.stages.sdf_deform_pretrain_steps}"
        f"_seed{cfg.seed}.npz")
    return pcache, ncache


def cached_sdf_pretrain(model, gparams: dict, steps: int, cache_path: str,
                        gt_sdf: Optional[torch.Tensor] = None):
    """``model.pretrain_sdf`` to the template's SDF, its ``sdf_net`` cached
    in ``cache_path`` (ref hmsdf.py:251-253): a hit loads the subtree and
    keeps the rest of ``gparams``. Returns (gparams, loss or None on a
    hit)."""
    if cache_path and os.path.exists(cache_path):
        print(f"[pretrain] cached sdf_net <- {cache_path}", flush=True)
        out = dict(gparams)
        out["sdf_net"] = load_params(cache_path, gparams["sdf_net"])
        return out, None
    if gt_sdf is None:
        gt_sdf = model.smpl_template_sdf()
    gparams, ploss = model.pretrain_sdf(gparams, gt_sdf, steps=steps)
    if cache_path:
        save_params(cache_path, gparams["sdf_net"])
    return gparams, ploss
