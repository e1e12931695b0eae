"""Settings of the benchmark's tests: the ``cuda`` marker (a test that
needs a card asks for the ``cuda_device`` fixture, which skips without
one) and the CPU-sized cells under ``data/``."""

import os

import pytest
import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (run on the card with "
        "python -m pytest -m cuda d3h_bench/tests)")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session", autouse=True)
def _threads():
    torch.set_num_threads(2)
