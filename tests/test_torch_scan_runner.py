"""The port's scan runner (``run_async_scan``) on the CPU, against the JAX
reference's ``run_async_scan`` and against the port's own serial loop, and
the pieces that make its event capturable on the card.

Inputs are made once with numpy and fed to both packages.  With the
elementwise grad_fn of tests/test_torch_async_sim.py (grads = w - target)
the gradients are bit-equal in both frameworks, so whole runs are bit-equal
in final params, wire bytes and staleness; losses are reductions taken in
other orders and agree with the reference to 1e-6, and bit for bit with the
port's ``run``, whose ``M`` and ``v`` the scan also reproduces.  The
parameters are the reference scan test's shapes (``w`` 6 x 4, ``b`` 4), so
every wire segment is short enough for the CPU's tern sum to take the
reference's order.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import async_sim as jsim
from repro.core import make_strategy as jmake
from repro.core.engine import CompressionSpec as JSpec
from repro.core.scan_runner import run_async_scan as jscan
from repro_torch import core as tcore
from repro_torch.convert import params_from_numpy
from repro_torch.core import async_sim as tsim
from repro_torch.core import make_strategy as tmake
from repro_torch.core import scan_runner
from repro_torch.core import server as tserver
from repro_torch.core.engine import CompressionSpec as TSpec
from repro_torch.core.sparsify import SparseLeaf
from repro_torch.device import from_host
from repro_torch.kernels import build, scatter_apply
from repro_torch.models.mlp import MLP
from repro_torch.telemetry import Recorder

N_WORKERS, N_EVENTS, LR = 3, 40, 0.03


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(6, 4)).astype(np.float32),
              "b": np.zeros(4, np.float32)}
    pool = [{k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()} for _ in range(N_EVENTS)]
    stacked = {k: np.stack([p[k] for p in pool]) for k in params}
    return params, pool, stacked


def _jax_grad_fn(p, t):
    grads = jax.tree.map(lambda w, x: w - x, p, t)
    loss = sum(jnp.mean(g ** 2) for g in jax.tree.leaves(grads))
    return loss, grads


def _torch_grad_fn(p, t):
    grads = {k: p[k] - t[k] for k in p}
    loss = sum(torch.mean(g ** 2) for g in grads.values())
    return loss, grads


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_final(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(_np(a[key]), _np(b[key]))


def _same_hist(a, b, *, losses_exact=True):
    np.testing.assert_array_equal(a.worker_ids, b.worker_ids)
    np.testing.assert_array_equal(a.staleness, b.staleness)
    assert (a.up_bytes, a.down_bytes) == (b.up_bytes, b.down_bytes)
    if losses_exact:
        np.testing.assert_array_equal(a.losses, b.losses)
    else:
        np.testing.assert_allclose(a.losses, b.losses, rtol=1e-6)


# (strategy, kwargs, secondary_density, down quantize, server engine,
# block_r): the reference scan test's configurations
# (tests/test_scan_runner.py, both tests), plus the kernel path: a
# blockwise dgs worker with int8 up and a blockwise block_r=4 server
_CONFIGS = [
    ("asgd", {}, None, "none", "exact", None),
    ("dgs", {"density": 0.2, "momentum": 0.7}, None, "none", "exact", None),
    ("dgs", {"density": 0.2, "momentum": 0.7, "quantize": "int8"}, None,
     "none", "exact", None),
    ("gd_async", {"density": 0.2}, None, "none", "exact", None),
    ("dgs", {"density": 0.2, "momentum": 0.7, "quantize": "int8"}, 0.1,
     "int8", "exact", None),
    ("dgs", {"density": 0.2, "momentum": 0.7, "quantize": "tern"}, 0.1,
     "bf16", "exact", None),
    ("asgd", {}, 0.1, "none", "exact", None),
    ("dgs", {"density": 0.2, "engine": "blockwise", "quantize": "int8"}, 0.1,
     "none", "blockwise", 4),
]
_IDS = ["asgd", "dgs", "dgs-int8", "gd_async", "dgs-int8-down-int8",
        "dgs-tern-down-bf16", "asgd-down", "dgs-blockwise-int8"]


def _spec(cls, eng, dq, block_r):
    return cls(engine=eng, quantize=dq,
               **({"block_r": block_r} if block_r else {}))


def _port_runs(name, kw, sec, dq, eng, block_r, *, metrics=False):
    """The port's scan (with its server state) and the port's run."""
    params, pool, stacked = _problem()
    sched = tsim.make_schedule(N_WORKERS, N_EVENTS, seed=7, hetero=0.9)
    spec = _spec(TSpec, eng, dq, block_r)
    scan = scan_runner.run_async_scan_with_state(
        tmake(name, **kw), _torch_grad_fn, params_from_numpy(params, "cpu"),
        sched, stacked, n_workers=N_WORKERS, lr=LR, secondary_density=sec,
        secondary_spec=spec, metrics=metrics, device="cpu")
    tr = tsim.AsyncTrainer(tmake(name, **kw), _torch_grad_fn, N_WORKERS,
                           lr=LR, secondary_density=sec, secondary_spec=spec,
                           device="cpu")
    tpool = [params_from_numpy(b, "cpu") for b in pool]
    run = tr.run(params_from_numpy(params, "cpu"), sched,
                 lambda e, k: tpool[e], metrics=metrics)
    return scan, run, (params, pool, stacked, sched)


def _assert_scan_is_run(scan, run):
    (fs, ss, hs), (fr, sr, hr) = scan, run
    _same_final(fs, fr)
    np.testing.assert_array_equal(ss.M.numpy(), sr.M.numpy())
    np.testing.assert_array_equal(ss.v.numpy(), sr.v.numpy())
    assert ss.t == sr.t == N_EVENTS
    _same_hist(hs, hr)


@pytest.mark.parametrize("name,kw,sec,dq,eng,block_r", _CONFIGS, ids=_IDS)
def test_scan_bit_equal_to_the_reference_scan_and_the_port_run(
        name, kw, sec, dq, eng, block_r):
    """The port's scan == the port's run in everything (losses, params, M,
    v, bytes, staleness) == the reference's scan in params, bytes and
    staleness, its losses to 1e-6."""
    scan, run, (params, _, stacked, sched) = _port_runs(
        name, kw, sec, dq, eng, block_r)
    _assert_scan_is_run(scan, run)
    jf, jh = jscan(jmake(name, **kw), _jax_grad_fn,
                   {k: jnp.asarray(v) for k, v in params.items()}, sched,
                   {k: jnp.asarray(v) for k, v in stacked.items()},
                   n_workers=N_WORKERS, lr=LR, secondary_density=sec,
                   secondary_spec=_spec(JSpec, eng, dq, block_r))
    _same_final(scan[0], jf)
    _same_hist(scan[2], jh, losses_exact=False)


def test_scan_dgc_bit_equal_to_the_reference_serial_run():
    """dgc_async against the reference's serial loop only: the reference's
    serial and vectorized DGC steps differ by an ulp (its own failing
    tests), and the port follows the serial one."""
    kw = {"density": 0.2}
    scan, run, (params, pool, _, sched) = _port_runs(
        "dgc_async", kw, 0.1, "none", "exact", None)
    _assert_scan_is_run(scan, run)
    jtr = jsim.AsyncTrainer(jmake("dgc_async", **kw), _jax_grad_fn, N_WORKERS,
                            lr=LR, secondary_density=0.1,
                            secondary_spec=JSpec(engine="exact"))
    jf, js, jh = jtr.run({k: jnp.asarray(v) for k, v in params.items()},
                         sched, lambda e, k: pool[e])
    _same_final(scan[0], jf)
    np.testing.assert_array_equal(scan[1].M.numpy(), np.asarray(js.M))
    np.testing.assert_array_equal(scan[1].v.numpy(), np.asarray(js.v))
    _same_hist(scan[2], jh, losses_exact=False)


@pytest.mark.parametrize("cfg", [0, 2, 6, 7], ids=[_IDS[i] for i in
                                                    (0, 2, 6, 7)])
def test_scan_metrics_change_no_bit_and_equal_the_run(cfg):
    """metrics=True folds every event inside the event function; it changes
    no data-plane bit, and the drained state equals run's."""
    off, _, _ = _port_runs(*_CONFIGS[cfg])
    on, run_on, (_, _, _, sched) = _port_runs(*_CONFIGS[cfg], metrics=True)
    _assert_scan_is_run(on, off)
    assert off[2].metrics is None
    md = on[2].metrics
    assert md == run_on[2].metrics
    assert md["n_events"] == N_EVENTS
    assert md["per_worker"] == np.bincount(
        sched, minlength=N_WORKERS).tolist()


def test_scan_of_an_mlp_with_tuple_batches_is_the_run():
    """An autograd grad_fn (the MLP's cross-entropy) on ``(x, y)`` batches
    stacked as a tuple of tensors: the scan is the port's run, bit for
    bit."""
    rng = np.random.default_rng(5)
    model = MLP((10, 16, 4), seed=1, device="cpu")
    xs = torch.from_numpy(rng.normal(size=(24, 8, 10)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 4, (24, 8)))
    sched = tsim.make_schedule(4, 24, seed=2, hetero=0.8)
    strat = tmake("dgs", density=0.1, momentum=0.7, quantize="int8",
                  engine="blockwise")
    spec = TSpec(engine="blockwise", block_r=4)
    scan = scan_runner.run_async_scan_with_state(
        strat, model.grad_fn, model.params(), sched, (xs, ys), n_workers=4,
        lr=0.05, secondary_density=0.1, secondary_spec=spec, device="cpu")
    tr = tsim.AsyncTrainer(strat, model.grad_fn, 4, lr=0.05,
                           secondary_density=0.1, secondary_spec=spec,
                           device="cpu")
    run = tr.run(model.params(), sched, lambda e, k: (xs[e], ys[e]))
    (fs, ss, hs), (fr, sr, hr) = scan, run
    _same_final(fs, fr)
    np.testing.assert_array_equal(ss.M.numpy(), sr.M.numpy())
    np.testing.assert_array_equal(ss.v.numpy(), sr.v.numpy())
    _same_hist(hs, hr)
    assert np.isfinite(hs.losses).all() and len(hs.losses) == 24


def test_run_async_scan_returns_the_final_model_and_history():
    """``repro_torch.core.run_async_scan`` has the reference's return:
    ``(final global model, History)``, and the recorder gets its spans and
    run summary."""
    params, _, stacked = _problem()
    sched = tsim.make_schedule(N_WORKERS, 12, seed=1, hetero=0.5)
    strat = tmake("dgs", density=0.2, quantize="int8")
    final, hist = tcore.run_async_scan(
        strat, _torch_grad_fn, params_from_numpy(params, "cpu"), sched,
        {k: v[:12] for k, v in stacked.items()}, n_workers=N_WORKERS, lr=LR,
        secondary_density=0.1, device="cpu")
    want, _, whist = scan_runner.run_async_scan_with_state(
        strat, _torch_grad_fn, params_from_numpy(params, "cpu"), sched,
        {k: v[:12] for k, v in stacked.items()}, n_workers=N_WORKERS, lr=LR,
        secondary_density=0.1, device="cpu")
    _same_final(final, want)
    _same_hist(hist, whist)
    assert hist.evals == [] and hist.metrics is None


def test_scan_recorder_spans_and_summary(tmp_path):
    params, _, stacked = _problem()
    sched = tsim.make_schedule(N_WORKERS, 10, seed=4, hetero=0.8)
    with Recorder(tmp_path) as rec:
        tcore.run_async_scan(
            tmake("dgs", density=0.2), _torch_grad_fn,
            params_from_numpy(params, "cpu"), sched,
            {k: v[:10] for k, v in stacked.items()}, n_workers=N_WORKERS,
            lr=LR, secondary_density=0.1, recorder=rec, metrics=True,
            device="cpu")
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert "scan/execute" in {ev["name"] for ev in trace["traceEvents"]}
    events = [json.loads(line) for line in
              (tmp_path / "events.jsonl").read_text().split("\n") if line]
    assert events[-1]["kind"] == "run_summary"
    assert events[-1]["runner"] == "scan"
    assert events[-1]["n_events"] == 10
    assert events[-1]["metrics"]["n_events"] == 10


def test_scan_device_none_is_the_card():
    params, _, stacked = _problem()
    sched = tsim.make_schedule(N_WORKERS, 4, seed=0)
    args = (tmake("dgs", density=0.2), _torch_grad_fn,
            params_from_numpy(params, "cpu"), sched,
            {k: v[:4] for k, v in stacked.items()})
    if torch.cuda.is_available():
        final, _ = tcore.run_async_scan(*args, n_workers=N_WORKERS, lr=LR)
        assert final["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tcore.run_async_scan(*args, n_workers=N_WORKERS, lr=LR)


# ------------------------------------------------------------ capture

def test_from_host_raises_under_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        from_host(np.arange(3), "cuda")
    # the CPU takes the host array as it is, capture or not
    assert from_host(np.arange(3), "cpu").tolist() == [0, 1, 2]


def test_launch_counters_count_replays_not_the_capture(monkeypatch):
    """A card whose current stream captures is faked: CUDA initialized,
    the stream capturing, then not."""
    info = build.KernelInfo(name="probe", source="-", replaces="-")
    other = build.KernelInfo(name="other", source="-", replaces="-")
    build.count(info)                  # a torch without CUDA: counts now
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    build.count(info)                  # the card, not capturing
    assert info.launches == 2
    capturing[0] = True
    with pytest.raises(RuntimeError, match="capture"):
        build.count(info)              # capture outside recording()
    with build.recording() as record:
        build.count(info, 2)
        build.count(other)
        build.count(info)
    assert (info.launches, other.launches) == (2, 0)  # capture adds nothing
    capturing[0] = False
    record.replay()
    assert (info.launches, other.launches) == (5, 1)
    record.replay(times=3)
    assert (info.launches, other.launches) == (14, 4)


@pytest.mark.parametrize("rows,lanes", [([4, 0, 2], 3), ([1], 1),
                                        ([5, 3], 2)])
def test_scatter_add_rows_device_rows_equal_host_rows(rows, lanes):
    """The plain version with the row ids as a tensor (what the scan runner
    passes: the device id of this event's worker) is the host-row call, bit
    for bit, planted duplicates and out-of-range indices included."""
    rng = np.random.default_rng(lanes)
    dense = rng.normal(size=(6, 900)).astype(np.float32)
    idx = rng.integers(-3, 903, (lanes, 50)).astype(np.int32)
    idx[0, ::4] = idx[0, 1]
    vals = (rng.normal(size=(lanes, 50)) * 1e3).astype(np.float32)
    want = scatter_apply.scatter_add_rows_(
        torch.from_numpy(dense.copy()), rows, torch.from_numpy(idx),
        torch.from_numpy(vals))
    got = scatter_apply.scatter_add_rows_(
        torch.from_numpy(dense.copy()), torch.tensor(rows),
        torch.from_numpy(idx), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  want.view(torch.int32).numpy())


def test_scatter_add_rows_device_rows_out_of_range_write_nothing():
    dense = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    idx = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    vals = torch.ones((2, 2))
    out = scatter_apply.scatter_add_rows_(dense.clone(), torch.tensor([7, 1]),
                                          idx, vals)
    want = dense.clone()
    want[1, 2:] += 1.0
    assert torch.equal(out, want)
    with pytest.raises(ValueError, match="device rows"):
        scatter_apply.scatter_add_rows_(dense.clone(),
                                        torch.tensor([0, 1], dtype=torch.int32),
                                        idx, vals)


@pytest.mark.parametrize("dense_down", [False, True])
def test_server_stages_take_a_device_worker_id(dense_down):
    """send_select and send_commit with the worker id as a one-element
    tensor (the scan's route) give what the host int gives."""
    rng = np.random.default_rng(9)
    params = params_from_numpy({"w": rng.normal(size=(5, 7)).astype(
        np.float32)}, "cpu")
    M0 = torch.from_numpy(rng.normal(size=35).astype(np.float32))
    v0 = torch.from_numpy(rng.normal(size=(4, 35)).astype(np.float32))
    results = []
    for wid in (2, torch.tensor([2])):
        s = tserver.init(params, 4)
        s.M.copy_(M0)
        s.v.copy_(v0)
        G = tserver.send_select(s, wid, secondary_density=None if dense_down
                                else 0.2)
        s = tserver.send_commit(s, wid, G)
        results.append((G, s.v.clone()))
    (ga, va), (gb, vb) = results
    if isinstance(ga, SparseLeaf):
        assert torch.equal(ga.values, gb.values)
        assert torch.equal(ga.indices, gb.indices)
    else:
        assert torch.equal(ga, gb)
    assert torch.equal(va, vb)
