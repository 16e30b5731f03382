"""The benchmark's own tests: ``python -m pytest cardbench/tests`` from the
repository's root. Tests marked ``card`` need an NVIDIA GPU and skip
elsewhere; each decides so in the ``card`` fixture, never at import."""

import pytest

from helpers import small_root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (CUDA); skipped without one")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the benchmark measures nothing on "
                    "the CPU")


@pytest.fixture
def small(tmp_path):
    return small_root(tmp_path)
