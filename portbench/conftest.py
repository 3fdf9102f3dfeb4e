"""pytest settings of the benchmark's own tests (``python3 -m pytest portbench/tests``).

Tests marked ``card`` need a CUDA card and skip without one; on the card:
``python3 -m pytest portbench/tests -m card``."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
