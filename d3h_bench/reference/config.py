"""Frozen configuration tree, JSON-loadable (counterpart of
``d3human_tpu/config.py``): the fields the stage steps, the validation
renders, the stage loops and the CLI read.

Field names and defaults are the JAX package's, so a JAX ``Config``
converts field by field (``from_jax_config``) and every JSON config loads
into both packages alike; a JSON key the tree does not hold is ignored,
as the JAX loader ignores unknown keys. The render's tile fields and
``backend`` are kept for that reason only: the port's rasterizer takes
its options from the caller.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field as dfield
from typing import Any, Mapping, Optional, Tuple


def _tup(x):
    return tuple(x) if isinstance(x, (list, tuple)) else x


@dataclass(frozen=True)
class FieldConfig:
    n_freq: int = 6
    n_freq_deform: int = 8       # the nonrigid DeformMLP's encoding
    d_hidden: int = 256
    n_hidden: int = 6
    skip_in: Tuple[int, ...] = (3,)
    pose_code_dim: int = 136     # fix_code's width
    cond_dim: int = 64           # per-frame latents cond / render_cond
    # the input and hidden layers' products from bfloat16-rounded inputs
    # and weights, accumulated in float32 (the output layer stays float32)
    use_bfloat16: bool = False


@dataclass(frozen=True)
class GeometryConfig:
    grid_res: int = 128
    mesh_scale: float = 1.0
    grid_scale: float = 1.2          # ref hmsdf.py:211 (verts *= 1.2)
    grid_y_offset: float = -0.1919   # ref hmsdf.py:210
    boxscale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    aabb: Tuple[float, ...] = (-1, -1, -1, 1, 1, 1)
    # lattice cropped to the canonical template's bbox + this margin
    # (0: the full box)
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
    texture_res: Tuple[int, int] = (1080, 1080)
    spp: int = 1
    # depth-peeled layers of the full (validation) render; training always
    # consumes the nearest layer
    layers: int = 1
    probe_res: int = 256
    env_scale: float = 2.0
    learn_lighting: bool = True
    background: str = "white"
    n_samples: int = 24
    # material clamp ranges (ref train.py:1587-1592)
    kd_min: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    kd_max: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    ks_min: Tuple[float, ...] = (0.0, 0.001, 0.0)
    ks_max: Tuple[float, ...] = (0.0, 1.0, 1.0)
    # the JAX rasterizer's options (see the module docstring)
    tile_h: int = 8
    tile_w: int = 128
    max_faces_per_tile: int = 512
    bin_expand: int = 16
    backend: str = "auto"
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
    lambda_diffuse: float = 0.15
    lambda_specular: float = 0.0025
    use_depth: bool = False
    use_eikonal: bool = True
    use_mesh_msdf_reg: bool = True
    perceptual_crop: int = 448
    collision_push_eps: float = 0.005
    # "conv" (ConvPerceptual), "pyramid", "none" or "mobilenet"
    # (models/mobilenet.py: the npz's weights when it exists, else the
    # He-init fallback; the repo holds no npz)
    perceptual_backbone: str = "conv"
    perceptual_npz: str = "d3h_bench.reference/data/mobilenet_v2_features.npz"


@dataclass(frozen=True)
class OptimConfig:
    learning_rate: Tuple[float, float] = (0.03, 0.005)
    warmup_iter: int = 300
    clip_max_norm: float = 0.0
    sdf_lr_mult: float = 1e-2
    init_lr_scale: float = 1.0
    light_grad_scale: float = 64.0
    hashgrid_grad_scale: float = 0.125
    nonrigid_begin: int = 20000      # ref train.py:1632


@dataclass(frozen=True)
class StageConfig:
    init_epoch: int = 2001
    split_epoch: int = 1001
    split_smpl_epoch: int = 1001
    fine_epoch: int = 1001
    seq_epoch: int = 50001
    seq_max_frames: int = 20
    seq_iters_first: int = 1000
    seq_iters_rest: int = 300
    sdf_mlp_pretrain_steps: int = 3000
    sdf_deform_pretrain_steps: int = 1000
    save_checkpoint_interval: int = 500
    save_interval: int = 100
    log_interval: int = 10
    # skinning weights transferred once at the rest template instead of at
    # the deformed positions every iteration (off: the reference's way)
    seq_static_skin_weights: bool = False
    # the synthetic ground truth rendered once per frame and cached in fp16
    # on the device (data/synthetic.py:CachedTargets) instead of rendered
    # anew every iteration
    synthetic_target_cache: bool = False


@dataclass(frozen=True)
class ParallelConfig:
    """The process layout of ``parallel/``: the frame-parallel seq stage
    shards its frames over ``frames_axis``, the data-parallel step its
    batch over ``data_axis``; one process (rank) a device."""

    data_axis: str = "data"
    frames_axis: str = "frames"
    n_frame_shards: int = 0          # 0: the world size


@dataclass(frozen=True)
class Config:
    field: FieldConfig = dfield(default_factory=FieldConfig)
    geometry: GeometryConfig = dfield(default_factory=GeometryConfig)
    texture: TextureConfig = dfield(default_factory=TextureConfig)
    render: RenderConfig = dfield(default_factory=RenderConfig)
    loss: LossConfig = dfield(default_factory=LossConfig)
    optim: OptimConfig = dfield(default_factory=OptimConfig)
    stages: StageConfig = dfield(default_factory=StageConfig)
    parallel: ParallelConfig = dfield(default_factory=ParallelConfig)
    out_dir: str = "out"
    data_dir: str = "data"
    gender: str = "neutral"
    seed: int = 0

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def from_jax_config(jcfg) -> Config:
    """Copy the fields of this tree out of a config object with the JAX
    package's layout (duck-typed: any object with those attributes)."""
    out = {}
    for f in dataclasses.fields(Config):
        src = getattr(jcfg, f.name)
        if f.default_factory is dataclasses.MISSING:
            out[f.name] = src
            continue
        cls = f.default_factory
        out[f.name] = cls(**{
            g.name: getattr(src, g.name) for g in dataclasses.fields(cls)})
    return Config(**out)


# flat reference-style JSON keys -> (section, field), so reference-shaped
# configs load unchanged (the JAX package's table)
_FLAT_KEYS = {
    "gshell_grid": ("geometry", "grid_res"),
    "mesh_scale": ("geometry", "mesh_scale"),
    "boxscale": ("geometry", "boxscale"),
    "aabb": ("geometry", "aabb"),
    "train_res": ("render", "train_res"),
    "texture_res": ("render", "texture_res"),
    "spp": ("render", "spp"),
    "probe_res": ("render", "probe_res"),
    "env_scale": ("render", "env_scale"),
    "background": ("render", "background"),
    "n_samples": ("render", "n_samples"),
    "ks_min": ("render", "ks_min"),
    "ks_max": ("render", "ks_max"),
    "learning_rate": ("optim", "learning_rate"),
    "loss": ("loss", "loss"),
    "sdf_regularizer": ("loss", "sdf_regularizer"),
    "msdf_reg_open_scale": ("loss", "msdf_reg_open_scale"),
    "msdf_reg_close_scale": ("loss", "msdf_reg_close_scale"),
    "eikonal_scale": ("loss", "eikonal_scale"),
    "iter": ("stages", "init_epoch"),
    "save_interval": ("stages", "save_interval"),
    "n_hidden": ("field", "n_hidden"),
    "d_hidden": ("field", "d_hidden"),
    "n_freq": ("field", "n_freq"),
    "skip_in": ("field", "skip_in"),
    "out_dir": (None, "out_dir"),
    "gender": (None, "gender"),
}


def _apply_overrides(cfg: Config, data: Mapping[str, Any]) -> Config:
    """JSON keys over ``cfg``: a flat reference key, a section given as a
    mapping (its unknown keys ignored), or a top-level field; unknown keys
    are ignored. ``loss`` is both a flat key (the image loss's name) and a
    section: a mapping value means the section."""
    names = {f.name for f in dataclasses.fields(cfg)}
    sections = {n: getattr(cfg, n) for n in names
                if dataclasses.is_dataclass(getattr(cfg, n))}
    top: dict = {}
    for key, value in data.items():
        if key in _FLAT_KEYS and not (key in sections
                                      and isinstance(value, Mapping)):
            sec, name = _FLAT_KEYS[key]
            if sec is None:
                top[name] = _tup(value)
            else:
                sections[sec] = dataclasses.replace(
                    sections[sec], **{name: _tup(value)})
        elif key in sections and isinstance(value, Mapping):
            known = {f.name for f in dataclasses.fields(sections[key])}
            sections[key] = dataclasses.replace(sections[key], **{
                k: _tup(v) for k, v in value.items() if k in known})
        elif key in names:
            top[key] = _tup(value)
    return dataclasses.replace(cfg, **{**sections, **top})


def load_config(path: Optional[str] = None,
                overrides: Optional[Mapping[str, Any]] = None) -> Config:
    """The default tree, then the JSON file at ``path``, then
    ``overrides``."""
    cfg = Config()
    if path is not None:
        with open(path) as f:
            cfg = _apply_overrides(cfg, json.load(f))
    if overrides:
        cfg = _apply_overrides(cfg, overrides)
    return cfg
