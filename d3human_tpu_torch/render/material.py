"""Material dictionaries and their ``.mtl`` files (counterpart of
``d3human_tpu/render/material.py``): materials are plain dicts
{'name', 'bsdf', 'kd' / 'ks' / 'ke' colours, 'map_*' paths, or texture
parameter trees}; ``save_mtl`` writes the JAX package's bytes."""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def load_mtl(path: str) -> List[Dict]:
    mats = []
    cur = None
    base = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key, vals = parts[0].lower(), parts[1:]
            if key == "newmtl":
                cur = {"name": vals[0], "bsdf": "kd"}
                mats.append(cur)
            elif cur is None:
                continue
            elif key == "bsdf":
                cur["bsdf"] = vals[0]
            elif key in ("kd", "ks", "ke"):
                cur[key] = np.asarray([float(v) for v in vals], np.float32)
            elif key.startswith("map_"):
                cur[key] = os.path.join(base, vals[0])
    return mats


def save_mtl(path: str, material: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"newmtl {material.get('name', 'defaultMat')}\n")
        f.write(f"bsdf   {material.get('bsdf', 'kd')}\n")
        for key in ("kd", "ks", "ke"):
            if key in material and not isinstance(material[key], dict):
                v = np.asarray(material[key]).reshape(-1)[:3]
                f.write(f"{key.capitalize()} {v[0]:f} {v[1]:f} {v[2]:f}\n")


def get_parameters(material: Dict) -> Dict:
    """The trainable entries of a material: its texture parameter trees."""
    return {key: material[key]
            for key in ("kd_ks", "kd", "ks", "normal", "kd_ks_back")
            if key in material and isinstance(material[key], dict)}


def merge_materials(materials: List[Dict]) -> Dict:
    """One material from several: the first, named after all of them."""
    if not materials:
        return {"bsdf": "kd"}
    merged = dict(materials[0])
    merged["name"] = "_".join(m.get("name", "m") for m in materials)
    return merged
