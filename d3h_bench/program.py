"""The system under test: the port's training step of a cell, built
through its public constructors from the benchmark's inputs, and the
port's kernel counters and kernel names."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch

from d3h_bench.inputs import Inputs, clone_tree

# the port's hand-written kernels (csrc/*.cu) as the profiler names them
PORT_KERNELS = ("first_k_count_kernel", "first_k_write_kernel",
                "scatter_keys_kernel", "segsum_tile_kernel",
                "segsum_carry_kernel", "resolve_tiles_kernel",
                "fill_keys_kernel", "scan_tile_sum_kernel",
                "scan_tile_kernel")
# kernel names of each counted wrapper, for the trace's completeness
COUNTED = {"first_k_indices": ("first_k_count_kernel",
                               "first_k_write_kernel"),
           "coo_scatter_add": ("segsum_tile_kernel", "segsum_carry_kernel"),
           "resolve_tiles": ("resolve_tiles_kernel",),
           "inclusive_scan": ("scan_tile_sum_kernel", "scan_tile_kernel")}


def is_kernel(name: str, names) -> bool:
    """Whether the profiler's kernel ``name`` is one of ``names``."""
    return any(n in name for n in names)


def configure() -> None:
    """The process settings every entry point of the port makes."""
    from d3human_tpu_torch.utils.backend import configure_backends

    configure_backends()


def geometry(inputs, cfg, device):
    """The port's ``GeometryModel`` on the grid read from the benchmark's
    file and the body model built from its tables."""
    from d3human_tpu_torch.models.geometry import GeometryModel
    from d3human_tpu_torch.models.smplx.deformer import SMPLXDeformer
    from d3human_tpu_torch.models.smplx.model import SMPLXModel
    from d3human_tpu_torch.ops import tet_grid

    if inputs.lattice is None:
        grid = tet_grid.load_reference_tet_grid(inputs.grid_file,
                                                device=device)
    else:
        grid = tet_grid.make_tet_grid(**inputs.lattice, device=device,
                                      cache_path=inputs.grid_file)
    model = SMPLXModel(**{k: (v.clone() if isinstance(v, torch.Tensor)
                              else v) for k, v in inputs.body.items()})
    deformer = SMPLXDeformer(model)
    canon = deformer.initialize(inputs.betas.clone())
    return GeometryModel(cfg, grid, deformer, canon)


def build_fit(inputs, config_file: str, device,
              overrides: Optional[dict] = None):
    """The port's ``GeometryModel`` of a fit cell (its ``pretrain_sdf`` is
    the timed call)."""
    from d3human_tpu_torch.config import load_config

    return geometry(inputs, load_config(config_file, overrides), device)


def build(inputs: Inputs, config_file: str, device,
          overrides: Optional[dict] = None) -> Tuple[object, Callable]:
    """(train state, step_fn) of the port for ``inputs.stage``: the grid
    read from the benchmark's file, the body model from its tables, the
    parameters a copy of the benchmark's; ``overrides`` over the file."""
    from d3human_tpu_torch.config import load_config
    from d3human_tpu_torch.models.geometry import SeqTemplate
    from d3human_tpu_torch.models.perceptual import make_perceptual
    from d3human_tpu_torch.models.texture import MLPTexture3D
    from d3human_tpu_torch.train.step import init_state, make_train_step

    cfg = load_config(config_file, overrides)
    geo = geometry(inputs, cfg, device)
    tex = MLPTexture3D(cfg.texture, ([0.0] * 6, [1.0] * 6), device)
    perceptual, _ = make_perceptual(cfg.loss.perceptual_backbone, device)
    template = None
    if inputs.template is not None:
        template = SeqTemplate(**clone_tree(inputs.template))
    state = init_state(inputs.stage, clone_tree(inputs.params), cfg)
    step_fn = make_train_step(inputs.stage, geo, tex, perceptual,
                              clone_tree(inputs.perc_params), cfg,
                              template=template)
    return state, step_fn


def reset_counts() -> None:
    from d3human_tpu_torch.ops import compaction, raster_resolve, scan, scatter

    for fn in (compaction.first_k_indices, scatter.coo_scatter_add,
               scan.inclusive_scan):
        fn.launches = 0
        fn.calls = 0
    raster_resolve.resolve_tiles.launches = 0
    raster_resolve.resolve_tiles.floor_launches = 0


def read_counts() -> Dict[str, int]:
    """Kernel launches of each wrapper since ``reset_counts``."""
    from d3human_tpu_torch.ops import compaction, raster_resolve, scan, scatter

    return {"first_k_indices": compaction.first_k_indices.launches,
            "coo_scatter_add": scatter.coo_scatter_add.launches,
            "resolve_tiles": raster_resolve.resolve_tiles.launches,
            "inclusive_scan": scan.inclusive_scan.launches}


KNN_SPAN = "d3h_bench.knn1"


@contextlib.contextmanager
def knn_spans():
    """A profiler range named ``KNN_SPAN`` around each call of the port's
    ``ops/knn.py:knn1`` from its callers (the geometry's collision loss
    and the deformer's weight transfer)."""
    from d3human_tpu_torch.models import geometry
    from d3human_tpu_torch.models.smplx import deformer

    inner = geometry.knn1

    def knn1(*a, **kw):
        with torch.profiler.record_function(KNN_SPAN):
            return inner(*a, **kw)

    mods = (geometry, deformer)
    saved = [m.knn1 for m in mods]
    for m in mods:
        m.knn1 = knn1
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.knn1 = f
