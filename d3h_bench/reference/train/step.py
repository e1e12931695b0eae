"""Training steps of the init, split and seq stages (counterpart of
``d3human_tpu/train/step.py:make_train_step``): loss tick, backward,
per-group Adam, and the post-step clamps. PyTorch runs it eagerly;
parameters update in place."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from d3h_bench.reference.config import Config
from d3h_bench.reference.models.geometry import GeometryModel, SeqTemplate
from d3h_bench.reference.models.perceptual import ConvPerceptual
from d3h_bench.reference.render import light as light_mod
from d3h_bench.reference.train import losses as L
from d3h_bench.reference.train.optim import StageAdam, named_leaves, resolve_lrs


@dataclasses.dataclass
class TrainState:
    params: dict          # {"geometry", "pose"[, "material", "light"]}
    opt: StageAdam
    step: int = 0


def init_state(stage: str, params: dict, cfg: Config) -> TrainState:
    lr_pos, lr_mat, lr_lgt = resolve_lrs(cfg.optim.learning_rate)
    if stage == "init":
        lr_pos *= cfg.optim.init_lr_scale
    opt = StageAdam(stage, params, lr_pos, lr_mat, lr_lgt,
                    cfg.optim.warmup_iter,
                    clip_max_norm=cfg.optim.clip_max_norm,
                    sdf_lr_mult=cfg.optim.sdf_lr_mult,
                    hashgrid_grad_scale=cfg.optim.hashgrid_grad_scale,
                    light_grad_scale=cfg.optim.light_grad_scale)
    return TrainState(params=params, opt=opt, step=0)


def stage_tick(stage: str, model: GeometryModel, tex_module,
               perceptual: ConvPerceptual, perc_params, params: dict,
               target: dict, it: int, cfg: Config, raster_opts=None,
               generator=None, draws=None,
               template: Optional[SeqTemplate] = None
               ) -> Dict[str, torch.Tensor]:
    """The loss dict of one iteration of ``stage``. ``draws`` injects the
    random numbers of the tick (see ``train/losses.py``); the seq stage
    needs its ``template``."""
    g, pose, mat = params["geometry"], params["pose"], params.get("material")
    if stage == "init":
        return L.tick_init(generator, model, g, pose, tex_module, mat,
                           perceptual, perc_params, target, it, cfg,
                           raster_opts, draws=draws)
    if stage == "split":
        return L.tick_split(generator, model, g, pose, tex_module, mat,
                            perceptual, perc_params, target, it, cfg,
                            raster_opts, draws=draws)
    if stage == "seq":
        if template is None:
            raise ValueError("the seq stage needs its template")
        return L.tick_seq(generator, model, g, pose, tex_module, mat,
                          perceptual, perc_params, template, target, it, cfg,
                          raster_opts, draws=draws)
    raise ValueError(f"stage {stage!r}: the port has the init, split and "
                     "seq stages")


def loss_and_grads(stage: str, model: GeometryModel, tex_module,
                   perceptual: ConvPerceptual, perc_params, params: dict,
                   target: dict, it: int, cfg: Config, paths,
                   raster_opts=None, generator=None, draws=None,
                   template: Optional[SeqTemplate] = None):
    """(loss dict, {path: grad or None}) of one tick w.r.t. ``paths``."""
    leaves = dict(named_leaves(params))
    for p in paths:
        leaves[p].requires_grad_(True)
    try:
        out = stage_tick(stage, model, tex_module, perceptual, perc_params,
                         params, target, it, cfg, raster_opts, generator,
                         draws, template)
        grads = torch.autograd.grad(out["total"], [leaves[p] for p in paths],
                                    allow_unused=True)
    finally:
        for p in paths:
            leaves[p].requires_grad_(False)
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in out.items()}
    return metrics, dict(zip(paths, grads))


def _post_step(params: dict, model: GeometryModel) -> None:
    model.clamp_params(params["geometry"])
    if params.get("light") is not None:
        light_mod.clamp_(params["light"])


def make_train_step(stage: str, model: GeometryModel, tex_module,
                    perceptual: ConvPerceptual, perc_params, cfg: Config,
                    raster_opts: Optional[dict] = None,
                    template: Optional[SeqTemplate] = None
                    ) -> Callable[..., Tuple[TrainState, Dict]]:
    """step_fn(state, target, generator, draws=None) -> (state, metrics).
    The seq stage trains on ``template``; a caller that wants static
    skinning weights passes one whose ``w_pts`` holds them."""

    def step_fn(state: TrainState, target: dict,
                generator: Optional[torch.Generator] = None, draws=None):
        metrics, grads = loss_and_grads(
            stage, model, tex_module, perceptual, perc_params, state.params,
            target, state.step, cfg, state.opt.trainable_paths(),
            raster_opts, generator, draws, template)
        state.opt.step(state.params, grads)
        _post_step(state.params, model)
        state.step += 1
        if stage == "split":
            # mSDF gradient telemetry: the garment/body boundary only moves
            # if gradient reaches the mSDF field
            gm = grads.get("geometry/msdf")
            if gm is not None:
                metrics["msdf_grad_norm"] = torch.sqrt((gm * gm).sum())
                metrics["msdf_grad_absmax"] = gm.abs().max()
        return state, metrics

    return step_fn
