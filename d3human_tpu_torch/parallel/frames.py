"""Frame-parallel seq stage and the data-parallel step (counterpart of
``d3human_tpu/parallel/frames.py``).

Frame-parallel seq: after the shared template is built, every frame gets
its own copy of the trainable parameters, initialised from the shared
post-split state, and its own optimizer, and optimizes ``n_iters``
iterations independently (no warm start from the frame before). The JAX
package vmaps one frame's optimization over the frame axis and shards it
over the device mesh; here each rank runs its contiguous block of frames,
one after another, and nothing crosses ranks until the end, when the
losses and the per-frame parameters are gathered.

Data parallel: the parameters and the optimizer are replicated, the batch
is split over the ranks, each rank sums its examples' gradients, one
all-reduce sums the ranks', and every rank takes the same optimizer step
with the batch mean, as the JAX package's gradient of the batch-mean loss.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from d3human_tpu_torch.config import Config
from d3human_tpu_torch.models.geometry import GeometryModel, SeqTemplate
from d3human_tpu_torch.parallel.mesh import (
    Mesh, make_data_mesh, make_frame_mesh, put_sharded, replicated,
    shard_leading, tree_map,
)
from d3human_tpu_torch.train.optim import (
    StageAdam, named_leaves, resolve_lrs,
)
from d3human_tpu_torch.train.stages import iteration_generator
from d3human_tpu_torch.train.step import (
    TrainState, _post_step, loss_and_grads, make_train_step,
)


def replicate_for_frames(params: dict, n_frames: int) -> List[dict]:
    """``n_frames`` independent copies of ``params`` (every tensor cloned),
    one a frame."""
    return [tree_map(torch.clone, params) for _ in range(n_frames)]


def _parallel_optimizer(stage: str, params: dict, cfg: Config, clip: float):
    """The JAX package's ``make_optimizer(stage, ...)`` with the geometry
    clip ``clip`` and the default ``sdf_lr_mult`` (1e-2): the parallel
    paths pass neither ``sdf_lr_mult`` nor ``init_lr_scale``."""
    lr_pos, lr_mat, lr_lgt = resolve_lrs(cfg.optim.learning_rate)
    return StageAdam(stage, params, lr_pos, lr_mat, lr_lgt,
                     cfg.optim.warmup_iter, clip_max_norm=clip,
                     hashgrid_grad_scale=cfg.optim.hashgrid_grad_scale,
                     light_grad_scale=cfg.optim.light_grad_scale)


def make_parallel_seq_runner(
    model: GeometryModel, tex_module, perceptual, perc_params,
    template: SeqTemplate, cfg: Config, n_frames: int, n_iters: int,
    mesh: Optional[Mesh] = None, raster_opts: Optional[dict] = None):
    """Returns ``(launch, mesh)``:

    ``launch(shared_params, targets, seed, draws=None) -> (per_frame,
    totals)``. ``targets`` is a sequence of ``n_frames`` target dicts of
    which a rank reads only its own block. Frame f's iteration ``it``
    draws from ``iteration_generator(seed, f * 100000 + it)`` (the same
    numbers on every rank and world size), or takes ``draws(f, it)``.
    ``per_frame[f]`` is frame f's parameter tree: on the device of the
    rank that optimized it; on rank 0 a CPU copy of every other rank's
    frames; None elsewhere. ``totals`` [n_frames, n_iters] (float32, CPU)
    holds every frame's loss at every iteration, on every rank.

    Each frame starts from its own copy of ``shared_params`` with a fresh
    ``StageAdam("seq", ...)`` (step count 0, so each frame clips and
    schedules on its own, as under the JAX package's vmap) with the
    config's ``clip_max_norm`` and the default ``sdf_lr_mult``."""
    mesh = mesh or make_frame_mesh(device=model.grid.verts.device)
    step_fn = make_train_step("seq", model, tex_module, perceptual,
                              perc_params, cfg, raster_opts,
                              template=template)
    block = shard_leading(mesh, n_frames)

    def launch(shared_params: dict, targets: Sequence[dict], seed: int,
               draws: Optional[Callable[[int, int], dict]] = None):
        shared = replicated(mesh, shared_params)
        totals = torch.zeros((n_frames, n_iters), dtype=torch.float32,
                             device=mesh.device)
        per_frame: List[Optional[dict]] = [None] * n_frames
        local = put_sharded(mesh, targets, n_frames)
        for f, params in zip(block, replicate_for_frames(shared,
                                                         len(block))):
            state = TrainState(params=params, opt=_parallel_optimizer(
                "seq", params, cfg, cfg.optim.clip_max_norm))
            target = local[f]
            for it in range(n_iters):
                gen = None if draws is not None else iteration_generator(
                    seed, f * 100000 + it, mesh.device)
                state, m = step_fn(state, target, gen, draws=(
                    draws(f, it) if draws is not None else None))
                totals[f, it] = m["total"].detach()
            per_frame[f] = state.params
        if mesh.group is not None:
            # every other rank's rows are zero: the sum is a gather
            dist.all_reduce(totals, group=mesh.group)
            mine = {f: tree_map(lambda t: t.detach().cpu(), per_frame[f])
                    for f in block}
            got = [None] * mesh.world if mesh.rank == 0 else None
            dist.gather_object(mine, got, dst=0, group=mesh.cpu_group)
            for part in got or ():
                for f, p in part.items():
                    if per_frame[f] is None:
                        per_frame[f] = p
        return per_frame, totals.cpu()

    return launch, mesh


def _add(a: Dict, b: Dict) -> Dict:
    return {k: b[k] if a[k] is None else a[k] if b[k] is None
            else a[k] + b[k] for k in a}


def _pairwise_sum(grads: List[Dict]) -> Dict:
    """The sum of gradient dicts as a balanced pairwise tree, so that a
    rank's partial sum over its block is a subtree of the whole batch's
    tree (world 1 and world 2 agree bit for bit)."""
    while len(grads) > 1:
        grads = [_add(grads[i], grads[i + 1]) if i + 1 < len(grads)
                 else grads[i] for i in range(0, len(grads), 2)]
    return grads[0]


def make_dp_train_step(
    stage: str, model: GeometryModel, tex_module, perceptual, perc_params,
    cfg: Config, template: Optional[SeqTemplate] = None,
    raster_opts: Optional[dict] = None, mesh: Optional[Mesh] = None,
    axis: str = "data"):
    """Replicated-gradient data parallelism for a stage (the reference's
    NCCL set-up never wraps its model). Returns ``(dp_step, opt_factory,
    mesh, block)``:

    ``dp_step(state, targets, draws_list) -> (state, metrics)`` takes a
    batch of B targets (B divisible by the world size) and, per example,
    a ``torch.Generator`` or the tick's injected draws; it updates
    ``state`` in place with one optimizer step on the batch-mean
    gradient at iteration ``state.step``. ``metrics`` maps each scalar
    loss to a [B] tensor, on every rank. ``opt_factory(params)`` is the
    optimizer the JAX package's DP step builds: the stage's groups with
    the geometry clipped at 1.0 whatever ``clip_max_norm`` says, the
    unscaled ``lr_pos`` (no ``init_lr_scale``) and the default
    ``sdf_lr_mult``. ``block(B)`` is the rank's range of the batch."""
    mesh = mesh or make_data_mesh(axis=axis, device=model.grid.verts.device)

    def opt_factory(params: dict) -> StageAdam:
        return _parallel_optimizer(stage, params, cfg, 1.0)

    def block(B: int) -> range:
        return shard_leading(mesh, B)

    def dp_step(state: TrainState, targets: Sequence[dict],
                draws_list: Sequence):
        B = len(targets)
        paths = state.opt.trainable_paths()
        grads, metrics = [], []
        for i, target in put_sharded(mesh, targets).items():
            d = draws_list[i]
            gen, draws = (d, None) if isinstance(d, torch.Generator) \
                else (None, d)
            m, g = loss_and_grads(
                stage, model, tex_module, perceptual, perc_params,
                state.params, target, state.step, cfg, paths, raster_opts,
                gen, draws, template)
            grads.append(g)
            metrics.append({k: v for k, v in m.items()
                            if isinstance(v, torch.Tensor) and v.dim() == 0})
        grad = _pairwise_sum(grads)
        keys = sorted(metrics[0])
        stacked = torch.zeros((B, len(keys)), dtype=torch.float32,
                              device=mesh.device)
        for i, m in zip(block(B), metrics):
            stacked[i] = torch.stack([m[k].float() for k in keys])
        if mesh.group is not None:
            leaves = dict(named_leaves(state.params))
            grad = {p: torch.zeros_like(leaves[p]) if g is None else g
                    for p, g in grad.items()}
            for p in paths:
                dist.all_reduce(grad[p], group=mesh.group)
            dist.all_reduce(stacked, group=mesh.group)
        state.opt.step(state.params, {p: None if g is None else g / B
                                      for p, g in grad.items()})
        _post_step(state.params, model)
        state.step += 1
        return state, {k: stacked[:, j] for j, k in enumerate(keys)}

    return dp_step, opt_factory, mesh, block
