"""The port's examples (``examples/*_torch.py``) in-process on the CPU at
reduced sizes: the federated run's measured bytes are its frames' bytes,
the serving run's replica and restored delta chain are the server's final
arena bit for bit, and the bandwidth study's bytes per iteration are the
JAX reference's ``run_strategy``'s, exactly."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.cluster import wire
from repro_torch.convert import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_federated_noniid_bytes_are_its_frames(monkeypatch):
    """3 clients x 8 rounds with partial participation, a straggler, a
    late joiner, an early leaver and injected drops: every UP frame the
    clients encode is the int8 frame of the arena's static k's, every
    DOWN frame the coordinator encodes the float32 one, and the measured
    up and down bytes are the served rounds' frames summed; the losses are
    finite."""
    sizes = {wire.UP: [], wire.DOWN: []}
    encode = wire.encode_message

    def tap(msg_type, *args, **kw):
        out = encode(msg_type, *args, **kw)
        if msg_type in sizes:
            sizes[msg_type].append(len(out[0]))
        return out

    monkeypatch.setattr(wire, "encode_message", tap)
    res = _example("federated_noniid_torch").main(
        ["--device", "cpu", "--clients", "3", "--rounds", "8"])
    hist = res["hist"]
    n = len(hist.losses)
    assert n > 0 and np.all(np.isfinite(hist.losses))
    assert set(sizes[wire.UP]) == {res["up_frame"]}
    assert set(sizes[wire.DOWN]) == {res["down_frame"]}
    assert len(sizes[wire.DOWN]) == n
    assert hist.up_bytes == sum(sizes[wire.UP][:n]) == n * res["up_frame"]
    assert hist.down_bytes == sum(sizes[wire.DOWN])


def test_serve_decode_replica_and_chain_equal_the_server():
    """40 events with a replica and a delta chain every 16: the replica's
    final arena and the restored chain are the server's final arena bit
    for bit, at the last version."""
    res = _example("serve_decode_torch").main(
        ["--device", "cpu", "--events", "40"])
    arena = res["arena"].view(torch.int32)
    assert torch.equal(res["replica"]["arena"].view(torch.int32), arena)
    assert torch.equal(res["chain"].view(torch.int32), arena)
    assert res["replica"]["version"] == res["chain_version"] == 40
    assert res["replica"]["diffs"] > 0


def test_bandwidth_study_bytes_equal_reference():
    """The study's six runs (asgd, dgs, dgs+2nd; dgs+2nd in bf16, int8 and
    tern) over 12 events of the 8-worker schedule: up and down bytes equal
    the reference's ``benchmarks.common.run_strategy`` with the same
    strategy, density, secondary density, quantize mode, shapes and
    schedule, from the reference's initial parameters and batches (carried
    across as numpy arrays), exactly."""
    from benchmarks.common import make_classification_problem, run_strategy
    study = _example("bandwidth_study_torch")
    n_events = 12
    jparams, jgrad, jbatch, _ = make_classification_problem(seed=0)
    want = {}
    for tag, name, secondary, mode in (
            ("asgd", "asgd", None, "none"), ("dgs", "dgs", None, "none"),
            ("dgs+2nd", "dgs", 0.01, "none"),
            ("dgs+2nd/bf16", "dgs", 0.01, "bf16"),
            ("dgs+2nd/int8", "dgs", 0.01, "int8"),
            ("dgs+2nd/tern", "dgs", 0.01, "tern")):
        _, hist, _ = run_strategy(
            name, jparams, jgrad, jbatch, n_workers=8, n_events=n_events,
            lr=0.08, density=0.01, momentum=0.7, secondary_density=secondary,
            seed=4, quantize=mode)
        want[tag] = (hist.up_bytes, hist.down_bytes)
    params0 = params_from_numpy({k: np.asarray(v)
                                 for k, v in jparams.items()}, "cpu")
    _, grad_fn, _ = study.problem("cpu")

    def batch_fn(e, k):
        # the reference's batches: a downward diff's frame (sparse or
        # dense) follows how many coordinates it changed
        x, y = jbatch(e, k)
        return (torch.from_numpy(np.array(x)),
                torch.from_numpy(np.asarray(y, np.int64)))

    got = study.measure(params0, grad_fn, batch_fn, n_events, "cpu")
    assert {tag: (up, down) for tag, (up, down, _) in got.items()} == want
    rows = study.rows(got, n_events, sum(v.numel()
                                         for v in params0.values()))
    assert len(rows) == 8 and rows[-1].startswith("fig4/model_1gbps")


@pytest.mark.parametrize("name", ("federated_noniid_torch",
                                  "serve_decode_torch",
                                  "bandwidth_study_torch"))
def test_examples_default_to_the_card(name):
    """Without ``--device`` an example asks for the card, which the CPU
    test machine lacks: it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError):
        _example(name).main({"federated_noniid_torch": ["--rounds", "2"],
                             "serve_decode_torch": ["--events", "4"],
                             "bandwidth_study_torch": ["--quick"]}[name])
