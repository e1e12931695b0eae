"""Stage artifacts (counterpart of part of ``d3human_tpu/train/stages.py``):
``export_stage_meshes`` writes a stage's extracted meshes as objs for the
host surgery between the split and the seq stage."""

from __future__ import annotations

import os
from typing import Dict

import torch

from d3human_tpu_torch.models.geometry import GeometryModel
from d3human_tpu_torch.utils import io as mesh_io


def export_stage_meshes(model: GeometryModel, params: Dict, save_path: str,
                        tag: str) -> Dict[str, str]:
    """Write ``split_{cloth,body}_imesh_<tag>.obj`` (the mSDF > 0 and < 0
    halves) and ``watertight_imesh_<tag>.obj`` (the SDF's closed surface)
    of ``params["geometry"]`` into ``save_path`` (ref train.py:977-989);
    returns their paths under ``cloth``, ``body`` and ``watertight``. The
    watertight mesh is the cloth extraction's watertight level: the JAX
    package extracts it a second time, with the same result."""
    out = {}
    with torch.no_grad():
        for name, sign in (("cloth", 1.0), ("body", -1.0)):
            mesh, _ = model.extract(params["geometry"], sign)
            out[name] = os.path.join(save_path,
                                     f"split_{name}_imesh_{tag}.obj")
            mesh_io.write_obj(out[name], *mesh_io.compact_mesh(
                mesh.verts, mesh.faces, mesh.face_valid))
            if name == "cloth":
                wt = mesh_io.compact_mesh(mesh.verts_wt, mesh.faces_wt,
                                          mesh.face_wt_valid)
    out["watertight"] = os.path.join(save_path,
                                     f"watertight_imesh_{tag}.obj")
    mesh_io.write_obj(out["watertight"], *wt)
    return out
