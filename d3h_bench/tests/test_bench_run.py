"""Whole runs of the CPU-sized cells under ``data/`` (the harness's look
for a card skipped): the result line, the reference against the port,
the faults and the control that ``correct`` has to catch."""

import json

import pytest

from d3h_bench import run
from d3h_bench.tests.conftest import DATA

SEED = 2 ** 33 + 17


def _run(cell, **kw):
    kw.setdefault("seconds", 0.2)
    return run.run(cell, kw.pop("seed", SEED), kw.pop("seconds"),
                   kw.pop("traced", False), "cpu", root=DATA, **kw)


def test_result_line_keys_and_the_reference_agreeing():
    r = _run("tiny.init")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}
    assert r["device"]["platform"] == "cpu"
    json.dumps(r)


@pytest.mark.parametrize("cell", ["tiny.split", "tiny_ref.init"])
def test_the_reference_agrees_with_the_port(cell):
    r = _run(cell)
    assert r["correct"] is True, r["checks"]


def test_seq_against_the_reference():
    r = _run("tiny.seq")
    # the port's ordered sums and the reference's index_add differ in the
    # last bits of the collision's gradient (see PERF.md): gaps stay small
    assert r["checks"]["loss_gap"]["value"] < 1e-2
    assert r["checks"]["grad_gap"]["value"] < 0.1


def test_traced_run_reads_its_metrics_on_the_cpu():
    r = _run("tiny.init", traced=True)
    assert "dispatch_ms" in r["metrics"]
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", ["stale_state", "half_gradient",
                                   "altered_loss"])
def test_a_broken_step_is_not_correct(fault):
    r = _run("tiny.init", fault=fault)
    assert r["correct"] is False, r["checks"]


def test_the_lower_precision_control_is_not_correct():
    r = _run("tiny.init", control="bf16")
    assert r["correct"] is False, r["checks"]


def test_the_fit_agrees_with_the_reference():
    gaps = {}
    r = _run("tiny.pretrain_sdf", gaps_out=gaps)
    assert r["correct"] is True, gaps
    assert r["attempted"] % 5 == 0 and r["failed"] == 0
    assert gaps["loss_gap"] < 1e-6 and gaps["grad_gap"] < 1e-5


@pytest.mark.parametrize("fault", ["stale_state", "half_gradient",
                                   "altered_loss", "half_batch"])
def test_a_broken_fit_is_not_correct(fault):
    r = _run("tiny.pretrain_sdf", fault=fault)
    assert r["correct"] is False, r["checks"]


def test_the_lower_precision_fit_is_not_correct():
    r = _run("tiny.pretrain_sdf", control="bf16")
    assert r["correct"] is False, r["checks"]


def test_same_seed_same_inputs():
    a = _run("tiny.init", seed=5)
    b = _run("tiny.init", seed=5)
    assert a["checks"] == b["checks"]
