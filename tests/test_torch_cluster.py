"""The port's cluster runtime on the CPU, against the JAX reference's.

Inputs are made with numpy and fed to both packages.  The grad_fn is
elementwise (grads = w - target), so gradients, and with them every
parameter, ``M`` and ``v``, are bit-equal in the two frameworks; losses are
reductions taken in other orders and agree to 1e-6 relative.  Within the
port a cluster run is bit-equal to ``AsyncTrainer.run``, losses included.
Every receive, join and connect is bounded by ``TIMEOUT``; TCP uses
127.0.0.1 only.
"""
import functools
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import run_inprocess as jrun_inprocess
from repro.cluster import scenarios as jscen
from repro.cluster import transport as jtransport
from repro.cluster.client import ClusterClient as JClient
from repro.cluster.coordinator import Coordinator as JCoordinator
from repro.core import async_sim as jsim
from repro.core import make_strategy as jmake
from repro.core.engine import CompressionSpec as JSpec
from repro_torch.cluster import run_inprocess, scenarios, transport, wire
from repro_torch.cluster.client import ClusterClient
from repro_torch.cluster.coordinator import Coordinator
from repro_torch.convert import params_from_numpy
from repro_torch.core import async_sim as tsim
from repro_torch.core import make_strategy as tmake
from repro_torch.core.engine import CompressionSpec as TSpec
from repro_torch.telemetry import Recorder

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 60.0
N_POOL = 64


def _problem():
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(6, 4)).astype(np.float32),
              "b": rng.normal(size=4).astype(np.float32)}
    pool = [{k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()} for _ in range(N_POOL)]
    return params, pool


def _jax_grad_fn(p, t):
    grads = jax.tree.map(lambda w, x: w - x, p, t)
    return sum(jnp.mean(g ** 2) for g in jax.tree.leaves(grads)), grads


def _torch_grad_fn(p, t):
    grads = {k: p[k] - t[k] for k in p}
    return sum(torch.mean(g ** 2) for g in grads.values()), grads


def _both(params, pool):
    """(params0, batch_fn) for the reference and for the port."""
    jpool = [{k: jnp.asarray(v) for k, v in b.items()} for b in pool]
    tpool = [params_from_numpy(b, "cpu") for b in pool]

    def pick(e, k):
        return (int(e) * 7 + int(k)) % N_POOL

    return (({k: jnp.asarray(v) for k, v in params.items()},
             lambda e, k: jpool[pick(e, k)]),
            (params_from_numpy(params, "cpu"),
             lambda e, k: tpool[pick(e, k)]))


def _assert_same_run(t_final, t_hist, j_final, j_hist, *, exact_losses):
    np.testing.assert_array_equal(t_hist.worker_ids, j_hist.worker_ids)
    np.testing.assert_array_equal(t_hist.staleness, j_hist.staleness)
    assert (t_hist.up_bytes, t_hist.down_bytes) == \
        (j_hist.up_bytes, j_hist.down_bytes)
    for key in j_final:
        np.testing.assert_array_equal(np.asarray(t_final[key]),
                                      np.asarray(j_final[key]))
    if exact_losses:
        np.testing.assert_array_equal(t_hist.losses, j_hist.losses)
    else:
        np.testing.assert_allclose(t_hist.losses, j_hist.losses, rtol=1e-6)


# the reference's parity configurations (tests/test_cluster.py)
_CONFIGS = [
    ("asgd", {}, None, "none"),
    ("dgs", {"density": 0.2, "momentum": 0.7}, 0.1, "none"),
    ("dgs", {"density": 0.2, "momentum": 0.7, "quantize": "int8"}, 0.1,
     "bf16"),
    ("gd_async", {"density": 0.2, "quantize": "tern"}, None, "none"),
]


@pytest.mark.parametrize("name,kw,sd,dq", _CONFIGS)
def test_inprocess_bit_equal_to_reference_and_serial(name, kw, sd, dq):
    params, pool = _problem()
    (jp, jbatch), (tp, tbatch) = _both(params, pool)
    sched = jsim.make_schedule(3, 40, seed=7, hetero=0.9)
    jf, jh = jrun_inprocess(jmake(name, **kw), _jax_grad_fn, jp, jbatch,
                            schedule=sched, lr=0.03, secondary_density=sd,
                            secondary_spec=JSpec(engine="exact", quantize=dq),
                            timeout=TIMEOUT)
    strat = tmake(name, **kw)
    spec = TSpec(engine="exact", quantize=dq)
    tf, th = run_inprocess(strat, _torch_grad_fn, tp, tbatch, schedule=sched,
                           lr=0.03, secondary_density=sd, secondary_spec=spec,
                           timeout=TIMEOUT)
    _assert_same_run(tf, th, jf, jh, exact_losses=False)
    # the port's own serial loop: bit-equal, losses too
    sf, _, sh = tsim.AsyncTrainer(strat, _torch_grad_fn, 3, lr=0.03,
                                  secondary_density=sd, secondary_spec=spec,
                                  device="cpu").run(tp, sched, tbatch)
    _assert_same_run(tf, th, sf, sh, exact_losses=True)
    assert th.metrics["n_events"] == 40
    assert sum(th.metrics["batch_sizes"]) == 40


@pytest.mark.parametrize("max_batch", [1, 2, None])
def test_batched_serving_is_bit_equal(max_batch, monkeypatch):
    """The coordinator drains runs of distinct clients as one server pass;
    the batches it forms are ``batch_schedule``'s, and any cap gives the
    serial loop's bits."""
    from repro_torch.cluster import runner
    monkeypatch.setattr(runner, "Coordinator",
                        functools.partial(Coordinator, max_batch=max_batch))
    params, pool = _problem()
    _, (tp, tbatch) = _both(params, pool)
    sched = tsim.make_schedule(5, 48, seed=3, hetero=0.5)
    strat = tmake("dgs", density=0.25, momentum=0.7, quantize="tern")
    spec = TSpec(engine="exact", quantize="int8")
    tf, th = run_inprocess(strat, _torch_grad_fn, tp, tbatch, schedule=sched,
                           lr=0.05, secondary_density=0.25,
                           secondary_spec=spec, timeout=TIMEOUT)
    sf, _, sh = tsim.AsyncTrainer(strat, _torch_grad_fn, 5, lr=0.05,
                                  secondary_density=0.25, secondary_spec=spec,
                                  device="cpu").run(tp, sched, tbatch)
    _assert_same_run(tf, th, sf, sh, exact_losses=True)
    want = [len(b) for b in tsim.batch_schedule(sched, max_batch=max_batch)]
    assert th.metrics["batch_sizes"] == want


@pytest.mark.parametrize("max_batch", [None, 1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_next_batch_is_batch_schedule(seed, max_batch):
    sched = tsim.make_schedule(6, 200, seed=seed, hetero=0.8)
    sd = transport.ScheduleDriven(sched)
    got = []
    while (b := sd.next_batch(max_batch)):
        got.append(b)
    want = tsim.batch_schedule(sched, max_batch=max_batch)
    assert [list(b) for b in want] == got
    jd = jtransport.ScheduleDriven(sched)
    assert [jd.next_batch(max_batch) for _ in got] == got


def _scenario_plans(pkg):
    return {
        "elastic_partial_faulty": (pkg.hetero_plans(
            4, 10, hetero=0.8, seed=3, participation=0.7, late_join=1,
            early_leave=1, bandwidth=1e5, drop_prob=0.15), True, None),
        "grow_and_reuse_slots": ([
            pkg.ClientPlan(client_id=0, n_rounds=4),
            pkg.ClientPlan(client_id=1, n_rounds=2),
            pkg.ClientPlan(client_id=2, n_rounds=4, join_time=10.0)],
            False, 1),
    }


@pytest.mark.parametrize("scenario", ["elastic_partial_faulty",
                                      "grow_and_reuse_slots"])
def test_scenario_mode_matches_reference(scenario):
    params, pool = _problem()
    (jp, jbatch), (tp, tbatch) = _both(params, pool)
    jplans, faults, n_workers = _scenario_plans(jscen)[scenario]
    tplans = _scenario_plans(scenarios)[scenario][0]
    assert [vars(p) for p in tplans] == [vars(p) for p in jplans]
    jf, jh = jrun_inprocess(jmake("dgs", density=0.25, momentum=0.7),
                            _jax_grad_fn, jp, jbatch, plans=jplans, lr=0.05,
                            secondary_density=0.25, inject_faults=faults,
                            n_workers=n_workers, timeout=TIMEOUT)
    tf, th = run_inprocess(tmake("dgs", density=0.25, momentum=0.7),
                           _torch_grad_fn, tp, tbatch, plans=tplans, lr=0.05,
                           secondary_density=0.25, inject_faults=faults,
                           n_workers=n_workers, timeout=TIMEOUT)
    _assert_same_run(tf, th, jf, jh, exact_losses=False)
    jc, tc = jh.metrics["counters"], th.metrics["counters"]
    for key in jc:
        if not key.endswith("/dups") and key not in ("dup",
                                                     "reply_cache_hits"):
            assert tc[key] == pytest.approx(jc[key], rel=1e-12), key
    if faults:
        drops = sum(c["drops"] for c in th.metrics["clients"].values())
        assert drops > 0, "the policy injected nothing: the test is vacuous"
        assert tc.get("dup", 0) == tc.get("reply_cache_hits", 0)
    else:
        assert set(th.worker_ids.tolist()) <= {0, 1}


def test_fault_accounting_matches_the_seeded_policy():
    """Every injected drop is recovered; the drop counts replay each
    injector's seeded rng, and the virtual time booked is the policy's
    formula over the frames served."""
    params, pool = _problem()
    _, (tp, tbatch) = _both(params, pool)
    n_rounds, drop_prob, bandwidth, delay = 6, 0.3, 1e5, 0.01
    plans = [scenarios.ClientPlan(client_id=c, n_rounds=n_rounds,
                                  compute_time=1.0 + 0.3 * c,
                                  bandwidth=bandwidth, delay=delay,
                                  drop_prob=drop_prob, seed=11)
             for c in range(3)]
    _, hist = run_inprocess(tmake("dgs", density=0.25, momentum=0.7),
                            _torch_grad_fn, tp, tbatch, plans=plans, lr=0.05,
                            secondary_density=0.25, inject_faults=True,
                            timeout=TIMEOUT)
    counters, clients = hist.metrics["counters"], hist.metrics["clients"]
    assert len(hist.losses) == 3 * n_rounds
    for p in plans:
        acct = clients[p.client_id]
        rng = np.random.default_rng(p.fault_policy(realtime=False).seed)
        draws = rng.random(n_rounds + acct["retries"])
        assert acct["drops"] == int((draws < drop_prob).sum())
        assert acct["retries"] >= acct["drops"]
        assert counters[f"client/{p.client_id}/events"] == n_rounds
        up = counters[f"client/{p.client_id}/up_bytes"]
        down = counters[f"client/{p.client_id}/down_bytes"]
        np.testing.assert_allclose(
            counters[f"client/{p.client_id}/virtual_cost"],
            n_rounds * delay + (up + down) / bandwidth, rtol=1e-9)
    assert sum(c["drops"] for c in clients.values()) > 0


def test_scenario_helpers_match_reference():
    for kw in (dict(), dict(participation=0.6, late_join=2, early_leave=1,
                            bandwidth=5e4, drop_prob=0.1, seed=4)):
        t = scenarios.hetero_plans(6, 12, **kw)
        j = jscen.hetero_plans(6, 12, **kw)
        assert [vars(p) for p in t] == [vars(p) for p in j]
        for tp_, jp_ in zip(t, j):
            assert vars(tp_.fault_policy()) == vars(jp_.fault_policy())
            assert [scenarios.participates(tp_, r) for r in range(30)] == \
                [jscen.participates(jp_, r) for r in range(30)]
    np.testing.assert_array_equal(
        scenarios.dirichlet_class_weights(16, 10, 0.1, seed=2),
        jscen.dirichlet_class_weights(16, 10, 0.1, seed=2))


def test_noniid_batches_are_seeded_and_skewed():
    from repro_torch.data.synthetic import ClassificationTask
    task = ClassificationTask(n_features=8, n_classes=10, batch_size=256,
                              device="cpu")
    data = scenarios.NonIIDClassification(task=task, alpha=0.05,
                                          n_clients=4)
    x, y = data.batch(3, 1)
    x2, y2 = data.batch(3, 1)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert x.shape == (256, 8) and y.dtype == torch.int64
    w = data.weights()[1]
    # the labels follow the client's skewed class distribution
    top = int(np.argmax(w))
    assert (y == top).float().mean().item() > w[top] - 0.15
    assert not torch.equal(y, data.batch(3, 2)[1])


def test_recorder_sees_every_stage(tmp_path):
    params, pool = _problem()
    _, (tp, tbatch) = _both(params, pool)
    sched = tsim.make_schedule(3, 12, seed=1)
    rec = Recorder(tmp_path)
    run_inprocess(tmake("dgs", density=0.25, quantize="int8"),
                  _torch_grad_fn, tp, tbatch, schedule=sched,
                  secondary_density=0.25, recorder=rec, timeout=TIMEOUT)
    rec.close()
    trace = (tmp_path / "trace.json").read_text()
    for span in ("client/step", "client/encode", "client/exchange",
                 "client/apply", "coord/server_batch", "coord/encode",
                 "coord/commit", "coord/reply"):
        assert f'"{span}"' in trace, span
    assert "run_summary" in (tmp_path / "events.jsonl").read_text()


def test_later_slices_raise_not_implemented():
    """What the sharded runtimes still leave to later slices raises:
    serving replicas from either sharded runtime; and the route exchange's
    per-rank leg refuses to run without the ranks' ProcessMesh.  (The
    sharded coordinators themselves are held to the reference in
    tests/test_torch_shard_cluster.py, the per-rank leg in
    tests/test_torch_distributed.py.)"""
    from repro_torch.core import distributed
    from repro_torch.core.paramspace import ShardSpec

    params, pool = _problem()
    _, (tp, tbatch) = _both(params, pool)
    strat = tmake("dgs", density=0.25)
    for kw in (dict(n_shards=2), dict(mesh_shards=2)):
        with pytest.raises(NotImplementedError, match="later slice"):
            run_inprocess(strat, _torch_grad_fn, tp, tbatch,
                          schedule=[0, 1], n_replicas=1, **kw)
    with pytest.raises(ValueError, match="ProcessMesh"):
        distributed.shard_exchange_batch(
            ShardSpec(bounds=(0, 2, 4)),
            torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros((1, 2)), use_mesh=True)


# ------------------------------------------------------------ TCP

_TCP = dict(strategy=("dgs", {"density": 0.25, "momentum": 0.7,
                              "quantize": "int8"}),
            sd=0.25, dq="bf16", n=3, events=24)


def _tcp_reference_run():
    params, pool = _problem()
    (jp, jbatch), _ = _both(params, pool)
    sched = jsim.make_schedule(_TCP["n"], _TCP["events"], seed=5, hetero=0.6)
    name, kw = _TCP["strategy"]
    jf, jh = jrun_inprocess(jmake(name, **kw), _jax_grad_fn, jp, jbatch,
                            schedule=sched, lr=0.05,
                            secondary_density=_TCP["sd"],
                            secondary_spec=JSpec(engine="exact",
                                                 quantize=_TCP["dq"]),
                            timeout=TIMEOUT)
    return sched, jf, jh


def _serve_over_tcp(coord_pkg, client_pkg, sched):
    """A schedule-driven run over TCP on 127.0.0.1: the coordinator from
    one package, the clients (threads) from the other."""
    params, pool = _problem()
    jside, tside = _both(params, pool)
    name, kw = _TCP["strategy"]
    if coord_pkg == "ref":
        ct = jtransport.TcpCoordinatorTransport()
        coord = JCoordinator(
            transport=ct, params0=jside[0], n_slots=_TCP["n"],
            secondary_density=_TCP["sd"],
            secondary_spec=JSpec(engine="exact", quantize=_TCP["dq"]),
            scheduler=jtransport.ScheduleDriven(sched), recv_timeout=TIMEOUT)
    else:
        ct = transport.TcpCoordinatorTransport()
        coord = Coordinator(
            transport=ct, params0=tside[0], n_slots=_TCP["n"],
            secondary_density=_TCP["sd"],
            secondary_spec=TSpec(engine="exact", quantize=_TCP["dq"]),
            scheduler=transport.ScheduleDriven(sched), recv_timeout=TIMEOUT)
    errors = []

    def client_main(cid):
        events = np.flatnonzero(np.asarray(sched) == cid)
        try:
            if client_pkg == "ref":
                t = jtransport.TcpClientTransport("127.0.0.1", ct.port, cid,
                                                  connect_timeout=TIMEOUT)
                c = JClient(transport=t, strategy=jmake(name, **kw),
                            grad_fn=_jax_grad_fn, params0=jside[0],
                            batch_fn=jside[1], lr=0.05,
                            plan=jscen.ClientPlan(client_id=cid,
                                                  n_rounds=len(events)),
                            event_fn=lambda s: events[s],
                            reply_timeout=TIMEOUT, max_retries=1)
            else:
                t = transport.TcpClientTransport("127.0.0.1", ct.port, cid,
                                                 connect_timeout=TIMEOUT)
                c = ClusterClient(transport=t, strategy=tmake(name, **kw),
                                  grad_fn=_torch_grad_fn, params0=tside[0],
                                  batch_fn=tside[1], lr=0.05,
                                  plan=scenarios.ClientPlan(
                                      client_id=cid, n_rounds=len(events)),
                                  event_fn=lambda s: events[s],
                                  recv_timeout=TIMEOUT)
            c.run()
            t.close()
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=client_main, args=(c,), daemon=True)
               for c in range(_TCP["n"])]
    for t in threads:
        t.start()
    try:
        final, hist = coord.serve(max_events=len(sched))
    finally:
        for t in threads:
            t.join(timeout=TIMEOUT)
        ct.close()
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return final, hist


@pytest.mark.parametrize("coord_pkg,client_pkg", [("ref", "port"),
                                                  ("port", "ref")])
def test_mixed_framework_tcp_is_bit_equal(coord_pkg, client_pkg):
    """Port clients against the reference's coordinator, and reference
    clients against the port's: both bit-equal to the reference's
    in-process run (losses computed by port clients agree to 1e-6)."""
    sched, jf, jh = _tcp_reference_run()
    final, hist = _serve_over_tcp(coord_pkg, client_pkg, sched)
    _assert_same_run(final, hist, jf, jh, exact_losses=client_pkg == "ref")


def test_tcp_launcher_smoke_on_cpu(tmp_path):
    """``python -m repro_torch.launch.cluster --smoke --device cpu``: a
    coordinator and two client processes over TCP."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster", "--smoke",
         "--device", "cpu", "--timeout", "60",
         "--trace-dir", str(tmp_path / "trace")],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "smoke OK" in proc.stdout
    assert (tmp_path / "trace" / "trace.json").exists()


def test_tcp_launcher_bytes_equal_inprocess(tmp_path):
    """The launcher with several hidden layers: its events and measured
    bytes equal a ``run_inprocess`` of the launcher's own problem (the
    served order differs, so only those)."""
    import re

    from repro_torch.launch import cluster as launcher

    flags = ["--clients", "2", "--rounds", "3", "--features", "16",
             "--hidden", "48,40", "--classes", "4", "--batch-size", "8",
             "--density", "0.1", "--quantize", "int8",
             "--secondary-density", "0.1", "--device", "cpu",
             "--timeout", "60"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster", *flags],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=240)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    events = int(re.search(r"\] (\d+) events in", out).group(1))
    up, down = map(int, re.search(r"up=(\d+) .* down=(\d+) ", out).groups())

    args = launcher.parse_args(flags)
    params0, grad_fn, batch_fn, _ = launcher.problem(args)
    assert [tuple(params0[f"w{i}"].shape) for i in (1, 2, 3)] == [
        (16, 48), (48, 40), (40, 4)]
    _, hist = run_inprocess(
        launcher.strategy(args), grad_fn, params0, batch_fn,
        schedule=np.tile(np.arange(args.clients), args.rounds),
        n_workers=args.clients, lr=args.lr,
        secondary_density=args.secondary_density,
        secondary_spec=launcher.secondary_spec(args), timeout=TIMEOUT)
    assert (events, up, down) == (len(hist.losses), hist.up_bytes,
                                  hist.down_bytes)


@pytest.mark.parametrize("late", [False, True])
def test_realtime_serving_waits_for_every_slot(late):
    """Real-time mode (no scheduler) serves until a client has joined every
    slot and each has left, also when one client connects only after the
    other has already said BYE (the TCP launcher's race)."""
    params, pool = _problem()
    _, (tp, tbatch) = _both(params, pool)
    hub = transport.InProcHub()
    coord = Coordinator(transport=hub.endpoint(wire.COORDINATOR_ID),
                        params0=tp, n_slots=2, secondary_density=0.25,
                        recv_timeout=TIMEOUT)
    served = []
    server = threading.Thread(target=lambda: served.append(coord.serve()),
                              daemon=True)
    server.start()
    strat = tmake("dgs", density=0.25, quantize="int8")
    endpoints = [hub.endpoint(c) for c in (0, 1)]

    def client(cid):
        return ClusterClient(transport=endpoints[cid], strategy=strat,
                             grad_fn=_torch_grad_fn, params0=tp,
                             batch_fn=tbatch, recv_timeout=TIMEOUT,
                             plan=scenarios.ClientPlan(client_id=cid,
                                                       n_rounds=3))

    if late:
        client(0).run()       # joins, is served 3 rounds, leaves
        client(1).run()       # joins only after the first has left
    else:
        threads = [threading.Thread(target=client(c).run, daemon=True)
                   for c in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    server.join(timeout=TIMEOUT)
    assert not server.is_alive()
    _, hist = served[0]
    assert len(hist.losses) == 6
    assert np.unique(hist.worker_ids, return_counts=True)[1].tolist() == [3, 3]


def test_mlp_grad_fn_is_thread_safe():
    """Many client threads call one model's grad_fn at once, each at its
    own params: every call sees its own weights (a grad_fn that swapped
    the module's parameters in place mixed them up across threads)."""
    from repro_torch.models.mlp import MLP

    model = MLP((16, 32, 4), device="cpu")
    rng = np.random.default_rng(3)
    trees = [{k: torch.from_numpy(rng.normal(size=v.shape)
                                  .astype(np.float32))
              for k, v in model.params().items()} for _ in range(8)]
    batch = (torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 4, 64)))
    want = [model.grad_fn(p, batch) for p in trees]
    got = [None] * len(trees)
    barrier = threading.Barrier(len(trees))

    def work(i):
        barrier.wait(timeout=TIMEOUT)
        for _ in range(20):
            got[i] = model.grad_fn(trees[i], batch)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(trees))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    for (wl, wg), (gl, gg) in zip(want, got):
        assert torch.equal(wl, gl)
        for key in wg:
            assert torch.equal(wg[key], gg[key]), key
