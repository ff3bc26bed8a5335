"""Assemble a whole cluster in one process, threads over ``InProcHub``
(PyTorch port of ``repro.cluster.runner``).

Two modes of :func:`run_inprocess`:

* ``schedule=...`` -- the bit-parity mode: the coordinator serves clients
  in exactly the given ``make_schedule`` order (client address == worker
  slot), reproducing ``AsyncTrainer.run`` bit for bit while every byte
  still crosses the real codec.
* ``plans=...`` -- the scenario mode: a :class:`transport.VirtualClock`
  orders events by per-client virtual time (compute speed + measured bytes
  / bandwidth + fault delay), with partial participation, joins and
  leaves, and seeded frame drops (``inject_faults``).

``n_replicas > 0`` attaches a live inference fleet: replica threads on the
same hub subscribe, pull re-sparsified model diffs between decode
boundaries and SYNC to the bit-exact final model.  ``ckpt_dir`` makes the
coordinator append delta checkpoints of the live arena.

The coordinator, every client and every replica compute on the device of
``params0``; all their threads share that device's current stream.  The
sharded and mesh coordinators (``n_shards``, ``mesh_shards``) are a later
slice of the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

import threading

import numpy as np

from repro_torch.core import engine as engine_lib
from repro_torch.core.engine import CompressionSpec

from . import wire
from .client import ClusterClient
from .coordinator import Coordinator
from .replica import InferenceReplica
from .scenarios import ClientPlan
from .transport import (FaultInjector, InProcHub, ScheduleDriven,
                        VirtualClock)

_LATER = "a later slice of the port (ROADMAP queue 1 item 3)"


def run_inprocess(
    strategy,
    grad_fn,
    params0,
    batch_fn,
    *,
    n_workers: int | None = None,
    schedule=None,
    plans: list[ClientPlan] | None = None,
    lr: float = 0.1,
    lr_fn=None,
    secondary_density: float | None = None,
    secondary_spec: CompressionSpec = engine_lib.EXACT_SPEC,
    inject_faults: bool = False,
    timeout: float = 300.0,
    recorder=None,
    n_shards: int = 1,
    mesh_shards: int = 0,
    n_replicas: int = 0,
    push_density: float | None = None,
    push_spec: CompressionSpec = engine_lib.EXACT_SPEC,
    max_staleness: int = 4,
    replica_decode_fn=None,
    ckpt_dir=None,
    ckpt_every: int = 0,
):
    """Run coordinator + clients on the in-process transport.

    Exactly one of ``schedule`` (parity mode) / ``plans`` (scenario mode)
    must be given.  Returns ``(final_params, History)`` like
    ``AsyncTrainer.run`` minus the server state; ``History.metrics`` holds
    the coordinator's counters and histograms, the server passes' batch
    sizes, and each client's retries and injected drops.  ``timeout``
    bounds every receive and every join.

    With ``n_replicas`` replicas, ``History.metrics["replicas"]`` holds each
    one's stats, final arena (a tensor on the device) and version; the
    training run's losses and bytes are untouched (serving reads M only).
    """
    if (schedule is None) == (plans is None):
        raise ValueError("pass exactly one of schedule= or plans=")
    for name, value, off in (("n_shards", n_shards, 1),
                             ("mesh_shards", mesh_shards, 0)):
        if value != off:
            raise NotImplementedError(f"run_inprocess({name}=...) is "
                                      f"{_LATER}")

    hub = InProcHub()
    if schedule is not None:
        schedule = np.asarray(schedule)
        n_workers = int(n_workers or (schedule.max() + 1))
        events_of = {k: np.flatnonzero(schedule == k)
                     for k in range(n_workers)}
        # a worker with no scheduled events would wait on WELCOME in vain
        plans = [ClientPlan(client_id=k, n_rounds=len(events_of[k]))
                 for k in range(n_workers) if len(events_of[k])]
        scheduler = ScheduleDriven(schedule)
        max_events = len(schedule)
        virtual_costs = None
    else:
        n_workers = n_workers or len(plans)
        events_of = None
        scheduler = VirtualClock()
        for p in plans:
            scheduler.register(p.client_id, t_join=p.join_time,
                               compute_time=p.compute_time)
        max_events = None
        virtual_costs = {p.client_id: p.fault_policy(realtime=False)
                         for p in plans}

    coord = Coordinator(
        transport=hub.endpoint(wire.COORDINATOR_ID),
        params0=params0,
        n_slots=n_workers,
        secondary_density=secondary_density,
        secondary_spec=secondary_spec,
        scheduler=scheduler,
        virtual_costs=virtual_costs,
        recv_timeout=timeout,
        recorder=recorder,
        push_density=push_density,
        push_spec=push_spec,
        min_subscribers=n_replicas,
        ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every,
    )

    clients, threads, errors, injectors = [], [], [], {}
    for p in plans:
        endpoint = hub.endpoint(p.client_id)
        if inject_faults:
            endpoint = FaultInjector(
                endpoint, p.fault_policy(realtime=False),
                droppable=lambda payload: payload[:1] == bytes([wire.UP]))
            injectors[p.client_id] = endpoint
        c = ClusterClient(
            transport=endpoint,
            strategy=strategy,
            grad_fn=grad_fn,
            params0=params0,
            batch_fn=batch_fn,
            plan=p,
            lr=lr,
            lr_fn=lr_fn,
            event_fn=(
                (lambda step, ev=events_of[p.client_id]: ev[step])
                if events_of is not None else None),
            reply_timeout=1.0 if inject_faults else None,
            recv_timeout=timeout,
            recorder=recorder,
        )
        clients.append(c)

        def _run(c=c):
            try:
                c.run()
            except Exception as exc:  # surface client failures to the caller
                errors.append(exc)

        t = threading.Thread(target=_run, daemon=True)
        threads.append(t)
        t.start()

    replica_results = [None] * n_replicas
    for i in range(n_replicas):
        r = InferenceReplica(
            hub.endpoint(wire.SUBSCRIBER_BASE + i), params0,
            replica_id=i, max_staleness=max_staleness,
            decode_fn=replica_decode_fn, recorder=recorder,
            recv_timeout=timeout)

        def _serve_replica(i=i, r=r):
            try:
                replica_results[i] = r.run()
            except Exception as exc:
                errors.append(exc)

        t = threading.Thread(target=_serve_replica, daemon=True)
        threads.append(t)
        t.start()

    try:
        final, hist = coord.serve(max_events=max_events)
    except Exception:
        if errors:   # a dead client explains the coordinator timeout better
            raise errors[0]
        raise
    for t in threads:
        t.join(timeout=timeout)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"a client or replica thread outlived the "
                           f"{timeout} s join")
    # fold the clients' fault accounting into the coordinator's metrics:
    # injected drops (from each FaultInjector) against observed retransmits
    per_client = {c.plan.client_id: {
        "retries": c.retries,
        "drops": getattr(injectors.get(c.plan.client_id), "dropped", 0),
    } for c in clients}
    metrics = {**hist.metrics, "clients": per_client}
    if n_replicas:
        metrics["replicas"] = [
            {"arena": r.arena, "version": r.version, **r.stats}
            for r in replica_results]
    return final, hist._replace(metrics=metrics)
