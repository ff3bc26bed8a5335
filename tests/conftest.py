"""Shared pieces of the tests: the ``card`` marker, a fixture that skips a
card test where there is no CUDA device (decided when the test runs, never
at import), and one torch intra-op thread a test process."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device; skips without one")


@pytest.fixture(scope="session", autouse=True)
def one_thread():
    """One intra-op thread for torch in each test process, as the rank and
    launcher subprocesses run (``OMP_NUM_THREADS=1``): lanes and ranks then
    round alike, and parallel test processes do not oversubscribe the CPU
    they share."""
    import torch

    torch.set_num_threads(1)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"
