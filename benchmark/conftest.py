"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the ``card`` marker, for tests that need a CUDA card
and skip without one (decided inside the ``card`` fixture, never while a
module is imported)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the card with "
                    "python -m pytest benchmark/tests -m card")
    return torch.device("cuda")
