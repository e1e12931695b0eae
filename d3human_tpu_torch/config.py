"""Frozen configuration tree: the fields the init-, split- and seq-stage
training steps and the validation render read.

A copy of ``d3human_tpu/config.py`` cut to these slices; field names and
defaults are the JAX package's, so a JAX ``Config`` converts field by field
(``from_jax_config``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field as dfield
from typing import Optional, Tuple


@dataclass(frozen=True)
class FieldConfig:
    n_freq: int = 6
    n_freq_deform: int = 8       # the nonrigid DeformMLP's encoding
    d_hidden: int = 256
    n_hidden: int = 6
    skip_in: Tuple[int, ...] = (3,)
    pose_code_dim: int = 136     # fix_code's width
    cond_dim: int = 64           # per-frame latents cond / render_cond


@dataclass(frozen=True)
class GeometryConfig:
    grid_res: int = 128
    mesh_scale: float = 1.0
    grid_crop: float = 0.0
    max_verts: int = 2 ** 18
    max_tets: int = 196608
    n_eikonal_samples: int = 50000
    # points per chunk of the SDF MLP over a longer point set, each chunk
    # recomputed in the backward (0: one unchunked pass)
    sdf_chunk: int = 131072

    @property
    def max_displacement(self) -> float:
        return 1.0 / self.grid_res * self.mesh_scale / 2.1


@dataclass(frozen=True)
class TextureConfig:
    """Hash-grid neural texture (ref render/mlptexture.py:51-116)."""

    channels: int = 6
    n_levels: int = 5
    n_features_per_level: int = 2
    log2_hashmap_size: int = 21
    base_resolution: int = 16
    desired_resolution: int = 4096
    ref_levels_for_scale: int = 16   # per_level_scale as if 16 levels
    internal_dims: int = 32
    hidden: int = 2
    gradient_scaling: float = 128.0
    # hard-coded sample bbox (ref mlptexture.py:94, a preserved quirk)
    bbox_lo: Tuple[float, float, float] = (0.6, 0.6, 0.2)
    bbox_hi: Tuple[float, float, float] = (-0.8, -1.2, -0.2)


@dataclass(frozen=True)
class RenderConfig:
    train_res: Tuple[int, int] = (1080, 1080)
    spp: int = 1
    # depth-peeled layers of the full (validation) render; training always
    # consumes the nearest layer
    layers: int = 1
    probe_res: int = 256
    max_covered_frac: float = 0.5
    jitter_subsample: int = 2
    # antialias every neighbour pair on the compacted path (instrumentation)
    aa_dense: bool = False
    init_shading: bool = False

    def __post_init__(self):
        if not (1 <= self.layers <= 4):
            raise ValueError(
                f"layers={self.layers}: depth peeling supports 1-4 layers")


@dataclass(frozen=True)
class LossConfig:
    loss: str = "logl1"
    sdf_regularizer: float = 0.2
    msdf_reg_open_scale: float = 1e-6
    msdf_reg_close_scale: float = 3e-6
    eikonal_scale: Optional[float] = None
    lambda_kd: float = 0.1
    lambda_ks: float = 0.05
    lambda_nrm: float = 0.025
    lambda_chroma: float = 0.0
    use_eikonal: bool = True
    use_mesh_msdf_reg: bool = True
    perceptual_crop: int = 448
    collision_push_eps: float = 0.005


@dataclass(frozen=True)
class OptimConfig:
    learning_rate: Tuple[float, float] = (0.03, 0.005)
    warmup_iter: int = 300
    clip_max_norm: float = 0.0
    sdf_lr_mult: float = 1e-2
    init_lr_scale: float = 1.0
    light_grad_scale: float = 64.0
    hashgrid_grad_scale: float = 0.125


@dataclass(frozen=True)
class StageConfig:
    init_epoch: int = 2001
    split_epoch: int = 1001
    seq_epoch: int = 50001
    seq_max_frames: int = 20
    seq_iters_first: int = 1000
    seq_iters_rest: int = 300
    # skinning weights transferred once at the rest template instead of at
    # the deformed positions every iteration (off: the reference's way)
    seq_static_skin_weights: bool = False


@dataclass(frozen=True)
class Config:
    field: FieldConfig = dfield(default_factory=FieldConfig)
    geometry: GeometryConfig = dfield(default_factory=GeometryConfig)
    texture: TextureConfig = dfield(default_factory=TextureConfig)
    render: RenderConfig = dfield(default_factory=RenderConfig)
    loss: LossConfig = dfield(default_factory=LossConfig)
    optim: OptimConfig = dfield(default_factory=OptimConfig)
    stages: StageConfig = dfield(default_factory=StageConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def from_jax_config(jcfg) -> Config:
    """Copy the fields of this tree out of a config object with the JAX
    package's layout (duck-typed: any object with those attributes)."""
    sections = {}
    for f in dataclasses.fields(Config):
        cls = f.default_factory
        src = getattr(jcfg, f.name)
        sections[f.name] = cls(**{
            g.name: getattr(src, g.name) for g in dataclasses.fields(cls)})
    return Config(**sections)
