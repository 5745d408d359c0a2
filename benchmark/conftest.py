"""pytest settings of the benchmark's own tests (benchmark/tests/):

    python -m pytest benchmark/tests -q

The ``cuda`` marker marks a test that needs an NVIDIA card; such a test asks
for the ``cuda_device`` fixture, which decides when the test runs, never
while a module is imported, and skips it on a machine without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this machine")
    return "cuda"
