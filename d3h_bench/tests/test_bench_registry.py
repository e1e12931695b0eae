"""Configurations, traffic mixes, cells and per-layer metrics are files
found by name, and BENCHMARK.json names only what is there."""

import json
import os

import pytest

from d3h_bench import registry

REPO = os.path.dirname(registry.ROOT)


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_cells_found_by_name():
    for w in _bench()["workloads"]:
        cell = registry.workload(w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"] == 1
        assert cell["why"] == w["why"]
        assert cell["limits"] and set(cell["limits"]) <= {
            "loss_gap", "grad_gap", "change_gap", "loss_gap_first",
            "grad_gap_median", "change_gap_median"}
        assert cell["traffic_data"]["stage"] in ("init", "split", "seq",
                                                 "pretrain_sdf")


def test_configs_found_by_name():
    for c in _bench()["configs"]:
        assert c["file"] == os.path.relpath(
            registry.config_path(c["name"]), REPO)
        data = registry.config(c["name"])
        for key in c["reduced"]:
            assert key in data
        assert "bench" in data


def test_unknown_names_raise():
    with pytest.raises(FileNotFoundError):
        registry.workload("no.such_cell")
    with pytest.raises(FileNotFoundError):
        registry.config("no_such_config")


def test_metrics_found_by_name():
    mods = registry.metrics()
    bench = _bench()
    names = {m["name"] for m in bench["per_layer"]}
    assert names <= set(mods)
    for m in bench["per_layer"]:
        mod = mods[m["name"]]
        assert mod.UNIT == m["unit"]
        assert mod.LAYER == m["layer"]
        assert mod.MOVES == m["moves"]
        assert mod.read({}) is None


def test_limits_of_the_data_cells():
    root = os.path.join(os.path.dirname(__file__), "data")
    cell = registry.workload("tiny.init", root)
    assert cell["config_data"]["bench"]["cache_name"] == "tiny"
