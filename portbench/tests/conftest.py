"""Shared pieces of the benchmark's tests: the ``card`` marker, a fixture
that skips a card test where there is no CUDA device (decided when the
test runs, never at import), and tiny cells of both reference families
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


TINY = {
    "ref_gqa": dict(d_model=16, n_heads=2, n_kv_heads=1, head_dim=8,
                    d_ff=16, vocab_size=32),
    "ref_mla": dict(d_model=16, n_heads=2, n_kv_heads=2, d_ff=16,
                    vocab_size=32,
                    mla=dict(q_lora_rank=8, kv_lora_rank=8,
                             qk_nope_head_dim=4, qk_rope_head_dim=4,
                             v_head_dim=4, absorb=False)),
}


def tiny_cell(name: str) -> harness.Cell:
    """The benchmark's cell ``name`` at a tiny size: its configuration's
    widths and its traffic's batch cut down, everything else (mode,
    workers, density, the limits) as the cell has it."""
    cell = harness.load_cell(name)
    config = copy.deepcopy(cell.config)
    config.update(TINY[config["reference"]])
    traffic = dict(cell.traffic, batch=8, seq=8, distinct_batches=4)
    traffic.pop("reference_rows", None)
    return harness.Cell(name=name, config=config, traffic=traffic,
                        limits=cell.limits, per_layer=[])


@pytest.fixture
def tiny():
    return tiny_cell
