"""The benchmark's own tests (``python -m pytest benchmark``)."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped on a host without one")


@pytest.fixture
def card():
    """The CUDA device of a test that needs the card; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its own size there")
    return "cuda"
