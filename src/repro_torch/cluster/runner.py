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

``n_shards > 1`` range-partitions the parameter arena across S coordinator
shards: each shard runs its OWN copy of the schedule over its own endpoint
and thread, clients fan every up-frame out by index range and merge the
per-shard downward diffs; losses and params reproduce the single-shard run
bit for bit (disjoint-range scatter-adds commute), and the bytes are S
envelopes per event.  ``mesh_shards = S`` runs the same partition as ONE
coordinator hosting all S shard arenas (the mesh server): clients see one
ordinary endpoint, and losses, params AND bytes reproduce the single
server.  The two are exclusive.

The coordinator(s), every client and every replica compute on the device
of ``params0``; all their threads share that device's current stream.
"""
from __future__ import annotations

import threading

import numpy as np

from repro_torch.core import engine as engine_lib
from repro_torch.core.engine import CompressionSpec
from repro_torch.core.paramspace import (ParamSpace, ShardSpec, tree_flatten,
                                         tree_leaves, tree_unflatten)

from . import wire
from .client import ClusterClient
from .coordinator import Coordinator
from .replica import InferenceReplica
from .scenarios import ClientPlan
from .transport import (FaultInjector, InProcHub, ScheduleDriven,
                        ShardEndpointView, VirtualClock)


def join_shards(params0, results):
    """Stitch S shard coordinators' ``(final, History)`` results into one:
    shard 0's History carries the event log (every shard served the
    identical stream), bytes sum across shards, the ``shard/*`` counters
    merge, and the shards' sub-trees join back into the full parameter
    tree (shard order == leaf order)."""
    final, hist = results[0]
    leaves = [leaf for f, _ in results for leaf in tree_leaves(f)]
    final = tree_unflatten(tree_flatten(params0)[1], leaves)
    counters = dict(hist.metrics["counters"])
    for _, h in results[1:]:
        counters.update({k: v for k, v in h.metrics["counters"].items()
                         if k.startswith("shard/")})
    return final, hist._replace(
        up_bytes=sum(h.up_bytes for _, h in results),
        down_bytes=sum(h.down_bytes for _, h in results),
        metrics={**hist.metrics, "counters": counters})


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
    if mesh_shards and n_shards > 1:
        raise ValueError(
            "n_shards and mesh_shards are two different sharding runtimes "
            "(S coordinator threads vs one mesh server): pass exactly one "
            "of them")
    if n_replicas and n_shards > 1:
        raise NotImplementedError(
            "the serve leg subscribes to ONE coordinator arena; sharded "
            "serving needs per-shard subscriptions, a later slice of the "
            "port")
    if n_replicas and mesh_shards:
        raise NotImplementedError(
            "mesh-sharded serving is a later slice of the port, as in the "
            "reference: run replicas against an unsharded coordinator")
    if n_shards > 1:
        if plans is not None:
            raise NotImplementedError(
                "sharded runs are schedule-driven (parity mode); the "
                "VirtualClock scenario scheduler books per-client costs "
                "event by event, which S independent shard clocks cannot "
                "reproduce consistently")
        if inject_faults:
            raise NotImplementedError(
                "fault injection wraps a client's single endpoint; the "
                "sharded client multiplexes one endpoint across shard "
                "views: inject faults on single-shard runs")

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

    shard_spec = (ShardSpec.for_space(ParamSpace.from_tree(params0),
                                      n_shards) if n_shards > 1 else None)
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
        shard_spec=shard_spec,
        mesh_shards=mesh_shards,
        push_density=push_density,
        push_spec=push_spec,
        min_subscribers=n_replicas,
        ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every,
    )
    # shards 1..S-1: the same schedule, their own cursor and endpoint;
    # clients fan each UP out to all of them, so every shard sees the
    # identical event stream and the ScheduleDriven copies stay in lockstep
    shard_coords = [Coordinator(
        transport=hub.endpoint(wire.COORDINATOR_ID - s),
        params0=params0,
        n_slots=n_workers,
        secondary_density=secondary_density,
        secondary_spec=secondary_spec,
        scheduler=ScheduleDriven(schedule),
        recv_timeout=timeout,
        recorder=recorder,
        shard_spec=shard_spec,
        shard_id=s,
    ) for s in range(1, n_shards)]

    clients, threads, errors, injectors = [], [], [], {}
    for p in plans:
        endpoint = hub.endpoint(p.client_id)
        if inject_faults:
            endpoint = FaultInjector(
                endpoint, p.fault_policy(realtime=False),
                droppable=lambda payload: payload[:1] == bytes([wire.UP]))
            injectors[p.client_id] = endpoint
        c = ClusterClient(
            transport=(endpoint if n_shards == 1 else
                       [ShardEndpointView(endpoint, wire.COORDINATOR_ID - s)
                        for s in range(n_shards)]),
            shard_spec=shard_spec,
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

    shard_results: list = [None] * n_shards
    coord_errors: list = []

    def _serve_shard(s, c):
        try:
            shard_results[s] = c.serve(max_events=max_events)
        except Exception as exc:
            coord_errors.append(exc)

    shard_threads = [threading.Thread(target=_serve_shard, args=(s, c),
                                      daemon=True)
                     for s, c in enumerate(shard_coords, start=1)]
    for t in shard_threads:
        t.start()
    try:
        shard_results[0] = coord.serve(max_events=max_events)
    except Exception:
        if errors:   # a dead client explains the coordinator timeout better
            raise errors[0]
        if coord_errors:
            raise coord_errors[0]
        raise
    for t in threads + shard_threads:
        t.join(timeout=timeout)
    if errors:
        raise errors[0]
    if coord_errors:
        raise coord_errors[0]
    if any(t.is_alive() for t in threads + shard_threads):
        raise TimeoutError(f"a client, shard or replica thread outlived "
                           f"the {timeout} s join")
    final, hist = join_shards(params0, shard_results)
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
