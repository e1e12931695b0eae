"""Parameter conversion from the JAX package's trees (as numpy arrays).

``params_from_jax`` takes a tree shaped like the JAX training params —
``{"geometry": ..., "pose": ..., "material": ..., "light": ...}``, leaves
numpy arrays (e.g. via ``jax.tree.map(np.asarray, params)``) — and returns
the same tree of tensors. Every part keeps its layout: MLP weights are
``[d_in, d_out]`` on both sides, the material is ``encoder.table`` (one
``[S, F]`` table per level) and ``net[i].w``, the light its ``base`` probe.
A tree without material or light converts to one without.
``stacked_params_from_jax`` takes frame f's tree out of the JAX
frame-parallel runner's output, whose every leaf has a leading frame axis.
``texture_from_jax_config`` builds the port's ``MLPTexture3D`` from the JAX
package's texture config and material range; ``perceptual_from_jax`` turns
ConvPerceptual's HWIO filters into PyTorch's OIHW; ``template_from_jax``
turns a seq template with the JAX ``SeqTemplate``'s fields (numpy arrays)
into the port's. ``mobilenet_from_jax`` turns MobileNetFeatures' HWIO
weights (depthwise included) into OIHW; ``lpips_from_jax`` carries
LPIPSLike's backbone and ``lin`` weights; ``tree_from_jax`` carries a tree
whose layout both packages share (``CondBNDecoder``'s ``{"w", "b"}``
linears, ``Texture2D``'s ``{"data"}``, the light's ``{"base"}``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device) for v in tree]
    return torch.as_tensor(np.array(tree)).to(device)


def params_from_jax(tree: dict, device="cuda") -> dict:
    return {k: _to_torch(tree[k], device)
            for k in ("geometry", "pose", "material", "light")
            if tree.get(k) is not None}


def _frame(tree, f: int):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _frame(v, f) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_frame(v, f) for v in tree]
    return np.asarray(tree)[f]


def stacked_params_from_jax(tree: dict, frame: int, device="cuda") -> dict:
    """``params_from_jax`` of frame ``frame`` of a params tree whose leaves
    are stacked over a leading frame axis."""
    return params_from_jax(_frame(tree, frame), device)


def texture_from_jax_config(jtex_cfg, min_max, device="cuda"):
    """The port's ``MLPTexture3D`` for a texture config with the JAX
    package's layout (duck-typed) and a (min [C], max [C]) material range."""
    from d3human_tpu_torch.config import TextureConfig
    from d3human_tpu_torch.models.texture import MLPTexture3D

    cfg = TextureConfig(**{
        f.name: getattr(jtex_cfg, f.name)
        for f in dataclasses.fields(TextureConfig)})
    return MLPTexture3D(cfg, (np.asarray(min_max[0], np.float32),
                              np.asarray(min_max[1], np.float32)), device)


def perceptual_from_jax(perc_params: dict, device="cuda") -> dict:
    """{"ws": [HWIO [3, 3, cin, cout]]} -> {"ws": [OIHW [cout, cin, 3, 3]]}."""
    return {"ws": [torch.as_tensor(np.array(w)).permute(3, 2, 0, 1)
                   .contiguous().to(device) for w in perc_params["ws"]]}


def template_from_jax(jtemplate, device="cuda"):
    """The port's ``SeqTemplate`` from an object with the JAX
    ``SeqTemplate``'s fields as numpy arrays (duck-typed; ``w_pts`` may be
    None); dtypes are kept."""
    from d3human_tpu_torch.models.geometry import SeqTemplate

    return SeqTemplate(**{
        f.name: None if getattr(jtemplate, f.name) is None
        else torch.as_tensor(np.array(getattr(jtemplate, f.name))).to(device)
        for f in dataclasses.fields(SeqTemplate)})


def tree_from_jax(tree, device="cuda"):
    """A tree of numpy arrays (dicts, lists) as the same tree of tensors."""
    return _to_torch(tree, device)


def mobilenet_from_jax(params: dict, device="cuda") -> dict:
    """MobileNetFeatures' arrays in the JAX layout (``s<i>_<name>_w`` HWIO,
    a depthwise one [3, 3, 1, C]; ``_b``), from its params or its npz, as
    the port's OIHW tensors (a depthwise one [C, 1, 3, 3])."""
    out = {}
    for k, a in params.items():
        t = torch.as_tensor(np.array(a, np.float32))
        if k.endswith("_w"):
            t = t.permute(3, 2, 0, 1)
        out[k] = t.contiguous().to(device)
    return out


def lpips_from_jax(params: dict, device="cuda") -> dict:
    """LPIPSLike's {"backbone": ConvPerceptual's, "lin": [C_i]}."""
    return {"backbone": perceptual_from_jax(params["backbone"], device),
            "lin": _to_torch(params["lin"], device)}
