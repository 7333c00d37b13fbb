"""pytest settings of the benchmark's own tests (``portbench/tests``):
the ``card`` marker, and the fixture that decides, at run time and never
while a module is imported, whether a CUDA card is there."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "card: needs a CUDA card; skips without one (run on the card with "
        "`python3 -m pytest portbench/tests -m card`)",
    )


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.cuda.get_device_name(0)
