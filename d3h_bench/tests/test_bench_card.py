"""The CPU-sized cells on the card (``-m cuda``): the reference agrees
with the port's kernels, and the TF32 control and a broken step are not
correct."""

import pytest

from d3h_bench import run
from d3h_bench.tests.conftest import DATA

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["tiny.init", "tiny.split", "tiny.seq",
                                  "tiny_ref.init", "tiny.pretrain_sdf"])
def test_the_reference_agrees_on_the_card(cuda_device, cell):
    r = run.run(cell, 2 ** 34 + 3, 0.2, False, cuda_device, root=DATA)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu"


def test_the_tf32_control_is_not_correct_on_the_card(cuda_device):
    r = run.run("tiny.init", 2 ** 34 + 5, 0.2, False, cuda_device,
                control="tf32", root=DATA)
    try:
        assert r["correct"] is False, r["checks"]
    finally:
        run.program.configure()


@pytest.mark.parametrize("cell", ["tiny.init", "tiny.pretrain_sdf"])
def test_a_stale_state_is_not_correct_on_the_card(cuda_device, cell):
    r = run.run(cell, 2 ** 34 + 7, 0.2, False, cuda_device,
                fault="stale_state", root=DATA)
    assert r["correct"] is False, r["checks"]


def test_the_tf32_fit_is_not_correct_on_the_card(cuda_device):
    r = run.run("tiny.pretrain_sdf", 2 ** 34 + 9, 0.2, False, cuda_device,
                control="tf32", root=DATA)
    try:
        assert r["correct"] is False, r["checks"]
    finally:
        run.program.configure()
