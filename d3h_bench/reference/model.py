"""The reference's side of a cell: its train state and step built from
the benchmark's inputs with the plain copies of this package, and the
targets the port was fed."""

from __future__ import annotations

from typing import Callable

import torch

from d3h_bench.inputs import Inputs, clone_tree, to_device


def build(inputs: Inputs, device, raster_opts=None):
    """(train state, step_fn) of the reference for ``inputs.stage`` from
    the benchmark's initial parameters (``raster_opts`` to its
    rasterizer)."""
    from d3h_bench.reference.models.geometry import GeometryModel, SeqTemplate
    from d3h_bench.reference.models.perceptual import make_perceptual
    from d3h_bench.reference.models.smplx.deformer import SMPLXDeformer
    from d3h_bench.reference.models.smplx.model import SMPLXModel
    from d3h_bench.reference.models.texture import MLPTexture3D
    from d3h_bench.reference.ops import tet_grid
    from d3h_bench.reference.train.step import init_state, make_train_step

    cfg = inputs.cfg
    if inputs.lattice is None:
        grid = tet_grid.load_reference_tet_grid(inputs.grid_file,
                                                device=device)
    else:
        grid = tet_grid.make_tet_grid(**inputs.lattice, device=device,
                                      cache_path=inputs.grid_file)
    model = SMPLXModel(**clone_tree(inputs.body))
    deformer = SMPLXDeformer(model)
    canon = deformer.initialize(inputs.betas.clone())
    geo = GeometryModel(cfg, grid, deformer, canon)
    tex = MLPTexture3D(cfg.texture, ([0.0] * 6, [1.0] * 6), device)
    perceptual, _ = make_perceptual(cfg.loss.perceptual_backbone, device)
    template = None
    if inputs.template is not None:
        template = SeqTemplate(**clone_tree(inputs.template))
    state = init_state(inputs.stage, to_device(inputs.params, device), cfg)
    step_fn = make_train_step(inputs.stage, geo, tex, perceptual,
                              to_device(inputs.perc_params, device), cfg,
                              raster_opts=raster_opts, template=template)
    return state, step_fn


def target_fn(inputs: Inputs) -> Callable[[int], dict]:
    """Iteration ``it``'s target: its frame's ground truth."""
    order = inputs.frame_order

    def target(it: int) -> dict:
        return inputs.targets.frame_target(int(order[it % len(order)]))

    return target


def control_tf32() -> None:
    """The control's lower precision: TF32 in matrix products and cuDNN
    convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
