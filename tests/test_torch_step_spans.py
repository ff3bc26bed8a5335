"""The port's span recorder (``telemetry/trace.py``) and the spans of the
train step and the DGS exchange: parents and self time, the no-op
recorders, the device mode's events and profiler ranges (with a stand-in
for ``torch.cuda.Event`` on the CPU), a traced step bit-identical to an
untraced one, and ``launch/train.py --trace-dir``."""
import itertools
import json
import threading

import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import get_arch
from repro_torch.core.distributed import ExchangeConfig
from repro_torch.core.paramspace import tree_flatten, tree_leaves
from repro_torch.launch import train
from repro_torch.launch.mesh import LaneMesh
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import init_params
from repro_torch.telemetry import trace

W = 4


@pytest.fixture
def clock(monkeypatch):
    """``time.perf_counter`` of the recorder reads 0, 1, 2, ... seconds."""
    ticks = itertools.count()
    monkeypatch.setattr(trace.time, "perf_counter", lambda: float(next(ticks)))


def _events(rec):
    return [e for e in rec._trace if e["ph"] == "X"]


def test_spans_record_parents_and_self_time(clock):
    rec = telemetry.Recorder()
    # a clock tick at every enter and exit
    with rec.span("a", leaf=3):             # 0..7, children 1 + 3
        with rec.span("b"):                 # 1..2
            pass
        with rec.span("b"):                 # 3..6, its child 1
            with rec.span("c"):             # 4..5
                pass
    ev = {e["name"] + str(e["args"]["id"]): e for e in _events(rec)}
    a, b1, b2, c = ev["a0"], ev["b1"], ev["b2"], ev["c3"]
    assert a["args"] == {"id": 0, "leaf": 3}
    assert b1["args"] == {"id": 1, "parent": "a", "parent_id": 0}
    assert c["args"] == {"id": 3, "parent": "b", "parent_id": 2}
    assert a["dur"] == 7e6 and b2["dur"] == 3e6
    assert rec.totals() == {
        "a": {"count": 1, "host_s": 7.0, "self_s": 3.0, "device_s": None},
        "b": {"count": 2, "host_s": 4.0, "self_s": 3.0, "device_s": None},
        "c": {"count": 1, "host_s": 1.0, "self_s": 1.0, "device_s": None}}
    # each thread has its own stack: a span opened on another thread
    # while "a" is open here has no parent
    with rec.span("a"):
        t = threading.Thread(target=lambda: rec.span("d").__enter__()
                             .__exit__(None, None, None))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert "parent" not in next(e for e in _events(rec)
                                if e["name"] == "d")["args"]


def test_null_and_disabled_recorders_record_nothing(tmp_path):
    for rec in (telemetry.NULL, telemetry.NullRecorder()):
        assert not rec.enabled
        with rec.span("train/step", lane=1) as s:
            with rec.span("grads/lane"):
                pass
        assert s is trace._NULL_SPAN
        assert rec.totals() == {} and rec.flush() == []
    assert list(tmp_path.iterdir()) == []


class _Event:
    """A stand-in for ``torch.cuda.Event``: each record takes the next
    tick, and an elapsed time is in milliseconds."""

    ticks = itertools.count()

    def __init__(self, enable_timing):
        assert enable_timing
        self.t = None

    def record(self):
        self.t = next(self.ticks)

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_device_mode_times_spans_and_names_them_to_the_profiler(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    rec = telemetry.Recorder(device=True)
    with rec.span("train/exchange"):
        with rec.span("exchange/select"):
            pass
    # events recorded at enter and exit, nested: 0 [1 2] 3
    tot = rec.totals()
    assert tot["train/exchange"]["device_s"] == pytest.approx(3e-3)
    assert tot["exchange/select"]["device_s"] == pytest.approx(1e-3)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("grads/forward"):
            torch.ones(3).sum()
    names = [e.name for e in prof.events()]
    assert "grads/forward" in names and "train/exchange" not in names
    with pytest.raises(ValueError):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        telemetry.Recorder(device=True)


def _tiny_step(mode):
    cfg = get_arch("chatglm3-6b").reduced(n_layers=1, d_model=64, vocab=64)
    ex = ExchangeConfig(mode=mode, density=0.1, momentum=0.9,
                        engine="blockwise")
    return cfg, build_train_step(cfg, LaneMesh(W, "cpu"), ex, lr=0.05,
                                 remat=False)


def _run(mode, recorder):
    cfg, step = _tiny_step(mode)
    step.recorder = recorder
    params = init_params(cfg, seed=0, device="cpu")
    state = step.init_state(params)
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2 * W, 8),
                                         generator=gen)}
        params, state, loss = step(params, state, batch)
    return params, state, loss


def _ancestors(ev, by_id):
    out = []
    while "parent_id" in ev["args"]:
        ev = by_id[ev["args"]["parent_id"]]
        out.append(ev["name"])
    return out


@pytest.mark.parametrize("mode", ["allgather", "shardedps"])
def test_traced_step_is_bit_identical_and_nests_its_spans(mode):
    rec = telemetry.Recorder()
    traced = _run(mode, rec)
    plain = _run(mode, telemetry.NULL)

    def outputs(run):
        params, state, loss = run
        trees = (params, state.velocity, state.m_shard, state.v_shard)
        out = [x for t in trees for x in tree_leaves(t)] + [loss]
        return out + ([state.overflow] if mode == "shardedps" else [])

    for a, b in zip(outputs(traced), outputs(plain), strict=True):
        assert torch.equal(a, b)
    events = _events(rec)
    by_id = {e["args"]["id"]: e for e in events}
    for e in events:
        up = _ancestors(e, by_id)
        if e["name"].startswith("exchange/"):
            assert up[-2:] == ["train/exchange", "train/step"], e
        if e["name"].startswith("grads/"):
            assert up[-2:] == ["train/grads", "train/step"], e
    # a step selects once per (leaf, lane) upward; shardedps also
    # rescales after its buckets and selects M - v downward
    n_leaves = len(tree_flatten(traced[0])[0])
    per_pair = {"allgather": 1, "shardedps": 3}[mode]
    select = [(e["args"]["leaf"], e["args"]["lane"]) for e in events
              if e["name"] == "exchange/select"]
    assert sorted(select) == sorted(
        [(leaf, lane) for leaf in range(n_leaves) for lane in range(W)]
        * per_pair * 2)
    tot = rec.totals()
    assert tot["train/step"]["count"] == 2
    assert tot["grads/lane"]["count"] == tot["grads/forward"]["count"] == \
        2 * W
    assert {"exchange/layout", "exchange/collective",
            "exchange/scatter"} <= set(tot)
    assert ("exchange/bucket" in tot) == (mode == "shardedps")


def test_train_launcher_writes_the_step_spans(tmp_path):
    train.main(["--device", "cpu", "--devices", "1", "--steps", "2",
                "--batch", "4", "--seq", "16", "--trace-dir",
                str(tmp_path)])
    names = {e["name"] for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"train/step", "train/grads", "grads/forward", "grads/backward",
            "train/exchange", "exchange/select", "exchange/scatter",
            "train/apply"} <= names
    lines = [json.loads(x) for x in
             (tmp_path / "events.jsonl").read_text().splitlines()]
    rec = next(x for x in lines if x["kind"] == "span_totals")
    assert rec["steps"] == 2
    step = rec["spans"]["train/step"]
    assert step["count"] == 2 and step["device_ms"] is None
    assert 0 < step["self_ms"] < step["host_ms"]


def test_train_step_defaults_to_the_null_recorder():
    _, step = _tiny_step("allgather")
    assert step.recorder is telemetry.NULL
