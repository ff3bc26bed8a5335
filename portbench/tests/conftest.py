"""Shared pieces of the benchmark's tests: the ``card`` marker, a fixture
that skips a card test where there is no CUDA device (decided when the
test runs, never at import), and tiny cells of every reference family
that the CPU tests drive through the harness."""
import copy

import pytest
import torch

from portbench import harness


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny sizes run fastest on one thread, and the suite's workers
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


def tiny_cell(name: str) -> harness.Cell:
    """The benchmark's cell ``name`` at a tiny size: its configuration's
    widths (its reference's ``TINY``) and its traffic's batch cut down,
    everything else (mode, workers, density, the limits) as the cell has
    it."""
    cell = harness.load_cell(name)
    config = copy.deepcopy(cell.config)
    config.update(copy.deepcopy(harness.reference(config).TINY))
    traffic = dict(cell.traffic, batch=8, seq=8, distinct_batches=4)
    traffic.pop("reference_rows", None)
    return harness.Cell(name=name, config=config, traffic=traffic,
                        limits=cell.limits, per_layer=[])


@pytest.fixture
def tiny():
    return tiny_cell
