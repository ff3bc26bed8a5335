"""The port's sharded cluster runtimes on the CPU: S shard coordinators
(``n_shards``) and the mesh server (``mesh_shards``), in process against the
JAX reference's runs of the same problem, over TCP, and through the
launcher.

The problem is ``tests/test_torch_cluster.py``'s: an elementwise grad_fn,
so params, M, v and bytes are bit-equal in the two frameworks and losses
(reductions in other orders) agree to 1e-6 relative; within the port a
sharded run is bit-equal to the 1-shard run, losses included.  Every
receive, join and connect is bounded by ``TIMEOUT``; TCP uses 127.0.0.1.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from repro.cluster import run_inprocess as jrun_inprocess
from repro.core import async_sim as jsim
from repro.core import make_strategy as jmake
from repro.core.engine import CompressionSpec as JSpec
from repro_torch.cluster import run_inprocess, scenarios, transport, wire
from repro_torch.cluster.client import ClusterClient
from repro_torch.cluster.coordinator import Coordinator
from repro_torch.cluster.runner import join_shards
from repro_torch.core import make_strategy as tmake
from repro_torch.core.engine import CompressionSpec as TSpec
from repro_torch.core.paramspace import ParamSpace, ShardSpec
from repro_torch.launch import cluster as launcher
from test_torch_cluster import (ROOT, TIMEOUT, _assert_same_run, _both,
                                _jax_grad_fn, _problem, _torch_grad_fn)

# the reference's parity configurations (tests/test_cluster.py): the
# S-thread runtime's, and the mesh runtime's (which adds the sampled and
# blockwise engines)
_SHARDED = [
    ("asgd", {}, None, "none"),
    ("dgs", {"density": 0.2, "momentum": 0.7, "quantize": "int8"}, 0.1,
     "bf16"),
    ("dgc_async", {"density": 0.2, "momentum": 0.7}, None, "none"),
]
_MESH = _SHARDED[:2] + [
    ("dgs", {"density": 0.2, "momentum": 0.7, "engine": "sampled",
             "quantize": "bf16"}, None, "none"),
    ("dgs", {"density": 0.2, "momentum": 0.7, "engine": "blockwise",
             "quantize": "tern"}, 0.2, "none"),
    _SHARDED[2],
]


def _runs(name, kw, sd, dq, **sharding):
    """The reference's and the port's run of one configuration."""
    params, pool = _problem()
    (jp, jbatch), (tp, tbatch) = _both(params, pool)
    sched = jsim.make_schedule(3, 24, seed=7, hetero=0.9)
    ref = jrun_inprocess(jmake(name, **kw), _jax_grad_fn, jp, jbatch,
                         schedule=sched, lr=0.03, secondary_density=sd,
                         secondary_spec=JSpec(engine="exact", quantize=dq),
                         timeout=TIMEOUT, **sharding)
    port = run_inprocess(tmake(name, **kw), _torch_grad_fn, tp, tbatch,
                         schedule=sched, lr=0.03, secondary_density=sd,
                         secondary_spec=TSpec(engine="exact", quantize=dq),
                         timeout=TIMEOUT, **sharding)
    return ref, port, tp


def _shard_counters(hist):
    return {k: v for k, v in hist.metrics["counters"].items()
            if k.startswith("shard/") or k == "route_overflow"}


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("name,kw,sd,dq", _SHARDED)
def test_sharded_inprocess_equals_reference(n_shards, name, kw, sd, dq):
    """S shard coordinator threads: losses, worker ids, staleness, final
    params, bytes and every ``shard/*`` counter equal the reference's
    S-shard run (the empty shards of S = 4 included); the bytes are the
    per-shard static frames, S envelopes per event."""
    (jf, jh), (tf, th), tp = _runs(name, kw, sd, dq, n_shards=n_shards)
    _assert_same_run(tf, th, jf, jh, exact_losses=False)
    assert _shard_counters(th) == _shard_counters(jh)
    space = ParamSpace.from_tree(tp)
    spec = ShardSpec.for_space(space, n_shards)
    up_seg = tmake(name, **kw).message_seg(space)
    if up_seg is not None:
        per_event = sum(wire.shard_frame_bytes_static(
            spec, up_seg, kw.get("quantize", "none")))
        assert th.up_bytes == per_event * len(th.losses)
    for s in range(n_shards):
        assert th.metrics["counters"][f"shard/{s}/events"] == 24
        assert th.metrics["counters"][f"shard/{s}/arena_elems"] == \
            spec.sizes[s]


@pytest.mark.parametrize("mesh_shards", [2, 4])
@pytest.mark.parametrize("name,kw,sd,dq", _MESH)
def test_mesh_inprocess_equals_reference(mesh_shards, name, kw, sd, dq):
    """The mesh server: losses, worker ids, staleness, final params, up and
    down bytes (the single server's) and the ``shard/*`` counters equal
    the reference's mesh run; ``route_overflow`` is 0."""
    (jf, jh), (tf, th), _ = _runs(name, kw, sd, dq, mesh_shards=mesh_shards)
    _assert_same_run(tf, th, jf, jh, exact_losses=False)
    assert _shard_counters(th) == _shard_counters(jh)
    assert th.metrics["counters"]["route_overflow"] == 0


def test_sharded_runs_equal_the_single_server():
    """Within the port, an S-shard and a mesh run are bit-equal to the
    1-shard run (losses too); the mesh run's bytes are its bytes."""
    params, pool = _problem()
    _, (tp, tbatch) = _both(params, pool)
    sched = jsim.make_schedule(3, 24, seed=7, hetero=0.9)
    strat = tmake("dgs", density=0.2, momentum=0.7, quantize="int8")
    spec = TSpec(engine="exact", quantize="bf16")
    runs = [run_inprocess(strat, _torch_grad_fn, tp, tbatch, schedule=sched,
                          lr=0.03, secondary_density=0.1, secondary_spec=spec,
                          timeout=TIMEOUT, **kw)
            for kw in ({}, {"n_shards": 4}, {"mesh_shards": 4})]
    (f1, h1), (f4, h4), (fm, hm) = runs
    _assert_same_run(fm, hm, f1, h1, exact_losses=True)
    np.testing.assert_array_equal(h4.losses, h1.losses)
    for key in f1:
        np.testing.assert_array_equal(f4[key].numpy(), f1[key].numpy())
    assert h4.up_bytes > h1.up_bytes     # S envelopes and headers


def _tcp_lockstep(n_shards, *, rounds=6, clients=3):
    """One TCP run of port coordinators and port clients (threads) over a
    lockstep round-robin schedule; returns (final, per-shard Histories)."""
    params, pool = _problem()
    _, (tp, tbatch) = _both(params, pool)
    strat = tmake("dgs", density=0.25, momentum=0.7, quantize="int8")
    order = np.tile(np.arange(clients), rounds)
    spec = (ShardSpec.for_space(ParamSpace.from_tree(tp), n_shards)
            if n_shards > 1 else None)
    cts = [transport.TcpCoordinatorTransport() for _ in range(n_shards)]
    coords = [Coordinator(transport=cts[s], params0=tp, n_slots=clients,
                          secondary_density=0.25, recv_timeout=TIMEOUT,
                          scheduler=transport.ScheduleDriven(order),
                          shard_spec=spec, shard_id=s)
              for s in range(n_shards)]
    errors, results = [], [None] * n_shards

    def client_main(cid):
        ts = []
        try:
            ts = [transport.TcpClientTransport("127.0.0.1", ct.port, cid,
                                               connect_timeout=TIMEOUT)
                  for ct in cts]
            ClusterClient(transport=ts if n_shards > 1 else ts[0],
                          shard_spec=spec, pin_slot=True, strategy=strat,
                          grad_fn=_torch_grad_fn, params0=tp,
                          batch_fn=tbatch, lr=0.05, recv_timeout=TIMEOUT,
                          plan=scenarios.ClientPlan(client_id=cid,
                                                    n_rounds=rounds)).run()
        except Exception as exc:
            errors.append(exc)
        finally:
            for t in ts:
                t.close()

    def serve(s):
        try:
            results[s] = coords[s].serve()
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=client_main, args=(c,), daemon=True)
               for c in range(clients)]
    threads += [threading.Thread(target=serve, args=(s,), daemon=True)
                for s in range(n_shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    for ct in cts:
        ct.close()
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return join_shards(tp, results)[0], [h for _, h in results]


def test_sharded_tcp_lockstep_is_bit_equal():
    """A 2-shard TCP cluster reproduces the 1-shard TCP run bit for bit
    under the same lockstep schedule: real sockets, split frames."""
    f1, (h1,) = _tcp_lockstep(1)
    f2, hs = _tcp_lockstep(2)
    for h in hs:      # every shard logged the identical event stream
        np.testing.assert_array_equal(h.losses, h1.losses)
        np.testing.assert_array_equal(h.worker_ids, h1.worker_ids)
    for key in f1:
        np.testing.assert_array_equal(f2[key].numpy(), f1[key].numpy())
    assert all(0 < h.up_bytes < h1.up_bytes for h in hs)


@pytest.mark.parametrize("flag", ["--shards", "--mesh-shards"])
def test_launcher_sharded_smoke_on_cpu(flag, tmp_path):
    """``python -m repro_torch.launch.cluster --smoke --device cpu
    --shards 2`` (or ``--mesh-shards 2``): a 1-shard lockstep reference and
    the sharded run over TCP, asserted bit-identical by the launcher."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster", "--smoke",
         "--device", "cpu", "--timeout", "60", flag, "2"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "bit-identical to the 1-shard reference" in out


def test_refusals_match_reference(capsys):
    """The reference's refusals, with its error types: both runtimes at
    once, replicas with either, and plans or fault injection with S
    coordinator shards; the launcher refuses both flags at once."""
    params, pool = _problem()
    _, (tp, tbatch) = _both(params, pool)
    strat = tmake("dgs", density=0.2, momentum=0.7)
    sched = np.zeros(4, np.int64)
    with pytest.raises(ValueError, match="exactly one"):
        run_inprocess(strat, _torch_grad_fn, tp, tbatch, schedule=sched,
                      n_shards=2, mesh_shards=2)
    with pytest.raises(NotImplementedError, match="mesh-sharded serving"):
        run_inprocess(strat, _torch_grad_fn, tp, tbatch, schedule=sched,
                      mesh_shards=2, n_replicas=1)
    with pytest.raises(NotImplementedError, match="sharded serving"):
        run_inprocess(strat, _torch_grad_fn, tp, tbatch, schedule=sched,
                      n_shards=2, n_replicas=1)
    with pytest.raises(NotImplementedError, match="schedule-driven"):
        run_inprocess(strat, _torch_grad_fn, tp, tbatch, n_shards=2,
                      plans=[scenarios.ClientPlan(client_id=0)])
    with pytest.raises(NotImplementedError, match="fault injection"):
        run_inprocess(strat, _torch_grad_fn, tp, tbatch, schedule=sched,
                      n_shards=2, inject_faults=True)
    with pytest.raises(ValueError, match="one"):
        Coordinator(transport=None, params0=tp, n_slots=1, mesh_shards=2,
                    shard_spec=ShardSpec.for_space(
                        ParamSpace.from_tree(tp), 2))
    with pytest.raises(ValueError, match="shard_spec"):
        ClusterClient(transport=[None, None], strategy=strat,
                      grad_fn=_torch_grad_fn, params0=tp, batch_fn=tbatch,
                      plan=scenarios.ClientPlan(client_id=0))
    with pytest.raises(SystemExit) as exit_info:
        launcher.parse_args(["--shards", "2", "--mesh-shards", "2"])
    assert exit_info.value.code == 2
    assert "exactly one" in capsys.readouterr().err
