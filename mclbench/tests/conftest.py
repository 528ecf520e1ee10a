"""Tests of the benchmark harness: on the CPU at small fleets (the port's
plain versions), and, marked ``cuda``, on the card."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips without one"
    )


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
