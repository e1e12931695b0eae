"""Configurations, traffic mixes, cells and per-layer metrics, each a
file of its own found by its name."""

from __future__ import annotations

import importlib
import json
import os
import pkgutil
from typing import Dict

ROOT = os.path.dirname(os.path.abspath(__file__))


def _json(kind: str, name: str, root: str = ROOT) -> dict:
    path = os.path.join(root, kind, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as fh:
        return json.load(fh)


def config_path(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "configs", f"{name}.json")


def config(name: str, root: str = ROOT) -> dict:
    return _json("configs", name, root)


def traffic(name: str, root: str = ROOT) -> dict:
    return _json("traffic", name, root)


def workload(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` with its config and traffic read in."""
    cell = dict(_json("workloads", name, root), name=name)
    cell["config_data"] = config(cell["config"], root)
    cell["config_file"] = config_path(cell["config"], root)
    cell["traffic_data"] = traffic(cell["traffic"], root)
    return cell


def metrics() -> Dict[str, object]:
    """Every reader module under ``metrics/`` by its name: each has
    ``UNIT``, ``LAYER``, ``MOVES`` and ``read(record) -> float | None``."""
    from d3h_bench import metrics as pkg

    out = {}
    for info in pkgutil.iter_modules(pkg.__path__):
        out[info.name] = importlib.import_module(
            f"d3h_bench.metrics.{info.name}")
    return out


def read_metrics(record: dict, stage: str) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every reader that finds something to
    read in ``record`` (a reader that finds nothing returns None)."""
    out = {}
    for name, mod in sorted(metrics().items()):
        stages = getattr(mod, "STAGES", None)
        if stages is not None and stage not in stages:
            continue
        value = mod.read(record)
        if value is not None:
            out[name] = {"value": value, "unit": mod.UNIT}
    return out
