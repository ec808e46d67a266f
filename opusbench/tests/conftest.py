"""The benchmark's own tests (python3 -m pytest opusbench/tests).

`cuda` marks a test that needs an NVIDIA GPU; it skips without one, the
decision taken inside the test (the `card` fixture), never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the benchmark measures the card); skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
