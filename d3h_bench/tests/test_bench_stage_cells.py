"""The checks of the seq and split cells (``f3c_seq.seq`` and
``f3c.split``) on their CPU-sized stand-ins under ``data/`` (``tiny.seq``,
``tiny.split``): the port agrees with the reference within the limits the
full-size cell compares, each fault that ``correct`` has to catch breaks
them, and every per-layer reader that lists the benchmark's seq cell
finds nothing in an empty record. ``f3c.split`` has its workload file
and limits but no entry in ``BENCHMARK.json``: its host-paced step
spreads too widely from run to run for the benchmark's bound."""

import json
import os

import pytest

from d3h_bench import check, registry, run
from d3h_bench.tests.conftest import DATA

SEED = 2 ** 33 + 53
# each CPU-sized stand-in and the full-size cell whose limits it is held to
CELLS = {"tiny.seq": "f3c_seq.seq", "tiny.split": "f3c.split"}
NEW = ("f3c_seq.seq",)          # the cells BENCHMARK.json runs


def _run(cell, **kw):
    gaps = {}
    r = run.run(cell, SEED, 0.2, False, "cpu", root=DATA, gaps_out=gaps,
                **kw)
    return r, gaps


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_port_is_correct_under_the_full_cells_limits(cell):
    limits = registry.workload(CELLS[cell])["limits"]
    r, gaps = _run(cell)
    assert r["correct"] is True, r["checks"]
    assert check.verdict(gaps, limits), (gaps, limits)


@pytest.mark.parametrize("fault", ["stale_state", "half_gradient",
                                   "altered_loss"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_broken_step_is_not_correct(cell, fault):
    limits = registry.workload(CELLS[cell])["limits"]
    r, gaps = _run(cell, fault=fault)
    assert r["correct"] is False, r["checks"]
    assert not check.verdict(gaps, limits), (gaps, limits)


def test_the_new_cells_readers_find_nothing_in_an_empty_record():
    with open(os.path.join(os.path.dirname(registry.ROOT),
                           "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    mods = registry.metrics()
    for name in NEW:
        listed = {m["name"] for m in bench["per_layer"]
                  if name in m.get("workloads", NEW)}
        assert listed >= {"device_busy_ms", "device_idle_pct",
                          "step_mfu_pct", "kernels_per_step", "resolve_ms",
                          "knn_ms"}, name
    for m in bench["per_layer"]:
        assert mods[m["name"]].read({}) is None, m["name"]
    for name in NEW:
        assert name in {w["name"] for w in bench["workloads"]}
