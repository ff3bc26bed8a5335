"""Shared pieces of the tests: the ``card`` marker, and a fixture that skips
a card test where there is no CUDA device (decided when the test runs,
never at import)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"
