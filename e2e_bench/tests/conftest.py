"""Tests of the port's benchmark.  They run on the CPU at tiny sizes; the
ones marked `cuda` need a card and skip without one (decided in the
`cuda_device` fixture, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the check at the cell's size runs on "
                    "the card")
    return torch.device("cuda:0")
