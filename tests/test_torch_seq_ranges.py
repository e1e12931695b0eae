"""The seq step's profiler ranges, the extraction's range and the
nearest-neighbour pair counter, on the benchmark's CPU-sized seq and split
cells (``d3h_bench/tests/data``) through the benchmark's own constructor
of the port's step (``d3h_bench/program.py:build``): each range shows once
a step under a profiler, ``span`` is the shared null context without one,
the counter adds P x M a search, and neither moves a bit of the step."""

import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from d3human_tpu_torch.ops import knn
from d3human_tpu_torch.utils import logging as port_logging

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "d3h_bench", "tests", "data")
SEED = 2 ** 33 + 29
# the ranges each stage's step opens once
RANGES = {"seq": ("d3h.seq.deform", "d3h.smplx.skin_weights",
                  "d3h.seq.collision", "d3h.seq.mesh_reg"),
          "split": ("d3h.geometry.extract", "d3h.smplx.skin_weights")}
NEW = ("d3h.seq.deform", "d3h.smplx.skin_weights", "d3h.seq.collision",
       "d3h.seq.mesh_reg", "d3h.geometry.extract")


@pytest.fixture(scope="module", params=["seq", "split"])
def cell(request):
    """(stage, the tiny cell, its inputs from the cell's seed)."""
    from d3h_bench import registry
    from d3h_bench.inputs import make_inputs

    cell = registry.workload(f"tiny.{request.param}", DATA)
    return request.param, cell, make_inputs(cell, SEED, torch.device("cpu"))


def _step(cell):
    """(state, step_fn, target, generator) of the cell's first step, the
    state built anew from the cell's inputs."""
    from d3h_bench import program
    from d3h_bench.loop import iteration_generator
    from d3h_bench.reference.model import target_fn

    _, cell, inputs = cell
    cpu = torch.device("cpu")
    state, step_fn = program.build(inputs, cell["config_file"], cpu)
    gen = iteration_generator(inputs.seeds["stage"], 0, cpu)
    return state, step_fn, target_fn(inputs)(0), gen


def test_no_range_is_opened_without_a_profiler(cell, monkeypatch):
    """Without a profiler every range of the step is ``span``'s shared
    null context: no ``record_function`` is made."""
    assert not torch.autograd._profiler_enabled()
    for name in NEW:
        assert port_logging.span(name) is port_logging._NO_SPAN
    opened = []
    inner = torch.profiler.record_function

    def record_function(name, *a, **kw):
        opened.append(name)
        return inner(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    state, step_fn, target, gen = _step(cell)
    step_fn(state, target, gen)
    assert opened == []


def test_each_range_once_a_step(cell):
    stage = cell[0]
    state, step_fn, target, gen = _step(cell)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step_fn(state, target, gen)
    names = [e.name for e in prof.events()]
    for r in RANGES[stage]:
        assert names.count(r) == 1, (r, names.count(r))
    if stage == "split":
        assert not any(n.startswith("d3h.seq.") for n in names)


def test_pair_counts_add_p_times_m_over_a_step(cell, monkeypatch):
    """``pair_counts()["knn1"]`` is the sum of P x M over the step's
    ``knn1`` calls (the weight transfer; in seq also the collision
    search), each call's shapes seen at its callers' import."""
    from d3human_tpu_torch.models import geometry
    from d3human_tpu_torch.models.smplx import deformer

    stage = cell[0]
    state, step_fn, target, gen = _step(cell)
    seen = []
    inner = knn.knn1

    def knn1(q, r, *a, **kw):
        seen.append(q.shape[0] * r.shape[0])
        return inner(q, r, *a, **kw)

    for mod in (geometry, deformer):
        monkeypatch.setattr(mod, "knn1", knn1)
    knn.reset_pair_counts()
    step_fn(state, target, gen)
    counts = knn.pair_counts()
    assert len(seen) == (2 if stage == "seq" else 1)
    assert counts == {"knn1": sum(seen), "knn": 0}
    knn.reset_pair_counts()
    assert knn.pair_counts() == {"knn1": 0, "knn": 0}


def test_ranges_and_counter_leave_the_step_bit_for_bit(cell):
    """The step's losses, first moments (its gradients as Adam got them)
    and parameters under a profiler equal those without one, bit for
    bit."""
    from d3h_bench.check import leaves

    out = []
    for traced in (False, True):
        state, step_fn, target, gen = _step(cell)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                state, metrics = step_fn(state, target, gen)
        else:
            state, metrics = step_fn(state, target, gen)
        out.append((metrics, dict(state.opt.mu), dict(leaves(state.params))))
    (m0, mu0, p0), (m1, mu1, p1) = out
    for k, v in m0.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, m1[k]), k
    assert mu0.keys() == mu1.keys() and mu0
    for k in mu0:
        assert torch.equal(mu0[k], mu1[k]), k
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_knn_adds_p_times_m():
    """``knn`` (the mesh SDF's search, a set-up path) counts P x M under
    its own key, apart from ``knn1``."""
    knn.reset_pair_counts()
    q, r = torch.rand(7, 3), torch.rand(11, 3)
    knn.knn(q, r, k=2, block=4)
    knn.knn1(q, r, block=4)
    assert knn.pair_counts() == {"knn1": 77, "knn": 77}
    knn.reset_pair_counts()
