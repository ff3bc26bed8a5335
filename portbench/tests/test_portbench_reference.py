"""The plain reference against the program at a tiny size on the CPU, so
that a fault of the reference never shows as a fault of the program on
the card; the comparison's control and the faults it has to catch, each
not correct; the wire counter; and a run on the card."""
import json
import math

import pytest

from portbench import harness, ref_dgs, run

CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("name", [c for c in CELLS if "dualway" not in c])
def test_reference_follows_the_program(tiny, name):
    # on the CPU the two agree but for the order of a few sums; the
    # control reads 1e-3 and more
    numbers = harness.readings(tiny(name), 2**31 + 3, "cpu")
    assert max(numbers.values()) < 1e-6


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny, name):
    """The reference computed in fp8 in the program's place fails the
    cell's limits."""
    cell = tiny(name)
    numbers = harness.readings(cell, 5, "cpu", control=True)
    assert any(numbers[k] > cell.limits[k] for k in numbers)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "no_exchange"])
def test_a_broken_step_is_not_correct(tiny, fault):
    result = harness.run(tiny("chatglm3-6b.allgather.s128"), seed=11,
                         seconds=0.05, trace=False, device="cpu",
                         t_start=0.0, fault=fault, log=lambda msg: None)
    assert result["correct"] is False
    assert list(result)[-1] == "check"


def test_a_sound_run_reports_its_metrics(tiny):
    cell = tiny("chatglm3-6b.dualway.s128")
    result = harness.run(cell, seed=12, seconds=0.05, trace=False,
                         device="cpu", t_start=0.0, log=lambda msg: None)
    assert result["correct"] is True and result["failed"] == 0
    # the reference follows the program's dual-way exchange too
    assert max(c["value"] for c in result["check"].values()) < 1e-6
    assert set(result["metrics"]) == {"tokens_per_s", "setup_s",
                                      "wire_bytes_per_worker_step"}
    # the payload each worker hands to and takes from the collectives
    tr, W = cell.traffic, cell.traffic["workers"]
    layout = harness.reference(cell.config).layout(cell.config)
    want = 4 + 4   # the loss's mean: its own loss, the mean
    for path, shape, _ in layout:
        c = ref_dgs.cut(path, shape, tr["mode"], tr["density"], W)
        want += 2 * c.S * W * c.cap * 8 + (1 + W) * c.S * c.k2 * 8
    assert result["metrics"]["wire_bytes_per_worker_step"]["value"] == want
    json.dumps(result, allow_nan=False)


@pytest.mark.card
def test_run_on_the_card(card, capsys):
    assert run.main(["--workload", CELLS[0], "--seed", "5", "--seconds",
                     "1", "--trace", "0"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert math.isfinite(result["metrics"]["tokens_per_s"]["value"])
