"""The whole schedule as one replayed program (PyTorch port of
``repro.core.scan_runner``): ``run_async_scan``.

The reference compiles every event into ONE XLA program (``lax.scan``).
Its counterpart on the card is a CUDA graph: the event is captured once and
replayed once per event, so the host enqueues one graph launch per event
instead of some fifty kernel wrappers and four hundred library kernels.
The event is built from the SAME stages as ``AsyncTrainer.run`` and the
cluster runtime (``async_sim.client_step_fn`` / ``server_step_fn``,
``server.send_commit`` / ``apply_update``, ``wire.quantize_message``
between them), so losses, final params, ``M``, ``v`` and the byte totals
are bit for bit those of ``run`` on the same schedule.

A graph bakes in pointers, so the event reads and writes device memory
only, laid out as the reference lays out its scan carry:

* worker models:   one ``(n_workers, total)`` arena ``wp``,
* worker strategy: each state tensor stacked on a leading worker axis,
* server ``M`` / ``v``: as ``server.init`` makes them, updated in place.

The event reads its worker id ``k = schedule[e]`` and its batch from
device buffers at a device event counter ``e``; gathers ``wp[k]`` into one
static ``theta`` (an allocation of its own, laid out like ``run``'s
per-worker copy, so a matmul library that picks its kernel by operand
alignment picks the same one) and the strategy rows into static buffers;
runs the four stages and both wire quantizes, with ``v`` indexed by the
device id (``server.send_select`` / ``send_commit``); writes ``theta`` and
the new strategy state back with ``index_copy_``; writes the loss, and a
dense message's nnz, into ``(n_events,)`` buffers at ``e``; and last
raises ``e``.

On the card the first event runs eagerly on a side stream.  It is a real
event, and it warms autograd, cuBLAS, the allocator and every cached table
(the wire quantize's segment tables cross to the card there, as nothing
may under capture: ``device.from_host`` raises).  The event is then
captured into one ``torch.cuda.CUDAGraph`` and replayed for the other
events, and one host sync at the end reads the losses and the nnz.  The
kernel wrappers' launch counters count each replay's launches
(``kernels.build.recording``).  On the CPU the same event runs eagerly for
every event.  The device decides the route; a capture that fails raises.

The reference puts ``optimization_barrier``s between the stages
(``stage``) and forces a dense upward message through a scatter
(``materialize_dense``) because XLA fuses across stages and would round
otherwise than the staged loop.  Eager PyTorch, and a graph of its
kernels, runs each stage's kernels as ``run`` does, so neither is needed.

Byte accounting as the reference's: sparse frames are static per
``(mode, seg, total)`` (``wire.frame_bytes_static``), so their total is
``n_events`` times one frame; dense messages' frames follow the per-event
nnz, through the codec's formula (``wire.dense_frame_bytes``) at the end.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.cluster import wire
from repro_torch.device import resolve_device
from repro_torch.telemetry import metrics as metrics_lib

from . import async_sim
from . import engine as engine_lib
from . import server as ps
from .baselines import Strategy, state_map, state_tensors
from .engine import CompressionSpec
from .paramspace import ParamSpace


def _tree_map(fn, tree):
    """``fn`` on each leaf of a tree of dicts, tuples and lists (a batch
    such as ``(x, y)`` or a dict of tensors)."""
    if isinstance(tree, dict):
        return {key: _tree_map(fn, val) for key, val in tree.items()}
    if isinstance(tree, (tuple, list)):
        parts = [_tree_map(fn, val) for val in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*parts)
        return type(tree)(parts)
    return fn(tree)


class _Event:
    """One event of the schedule, reading and writing device memory only:
    each call runs event ``self.e`` and raises it.  The buffers it fills
    (``losses``, and ``up_nnz`` / ``down_nnz`` for dense messages) are
    read once the run is over."""

    def __init__(self, strategy, grad_fn, space, sstate, wp, ws, schedule,
                 batches, lr, secondary_density, secondary_spec, ms,
                 staleness):
        dev = wp.device
        self.client = async_sim.client_step_fn(strategy, grad_fn, space)
        self.server = async_sim.server_step_fn(secondary_density,
                                               secondary_spec)
        self.sstate, self.wp, self.ws, self.lr = sstate, wp, ws, lr
        self.up_mode = strategy.quantize
        self.down_mode = secondary_spec.quantize
        self.up_seg = strategy.message_seg(space)
        self.down_seg = (space.ks(secondary_density)
                         if secondary_density is not None else None)
        n_events = len(schedule)
        self.schedule = torch.as_tensor(
            np.asarray(schedule, np.int64)).to(dev)
        self.batches = batches
        self.e = torch.zeros(1, dtype=torch.int64, device=dev)
        # the static gather buffers: theta an allocation of its own
        self.theta = torch.empty(space.total, dtype=torch.float32,
                                 device=dev)
        self.strat = state_map(lambda s: torch.empty_like(s[0]), ws)
        self.losses = torch.empty(n_events, dtype=torch.float32,
                                  device=dev)
        self.up_nnz = (torch.zeros(n_events, dtype=torch.int64, device=dev)
                       if self.up_seg is None else None)
        self.down_nnz = (torch.zeros(n_events, dtype=torch.int64,
                                     device=dev)
                         if self.down_seg is None else None)
        self.ms = ms
        self.staleness = (torch.as_tensor(np.asarray(staleness, np.int64))
                          .to(dev) if ms is not None else None)

    def __call__(self):
        e = self.e
        k = self.schedule.index_select(0, e)
        batch = _tree_map(lambda b: b.index_select(0, e)[0], self.batches)
        torch.index_select(self.wp, 0, k, out=self.theta[None])
        for dst, src in zip(state_tensors(self.strat),
                            state_tensors(self.ws)):
            torch.index_select(src, 0, k, out=dst[None])
        wst, loss, msg = self.client(self.theta, self.strat, batch, self.lr)
        msg = wire.quantize_message(msg, self.up_mode, seg=self.up_seg)
        sstate, G = self.server(self.sstate, msg, k)
        G = wire.quantize_message(G, self.down_mode, seg=self.down_seg)
        ps.send_commit(sstate, k, G)
        ps.apply_update(self.theta, G)
        self.wp.index_copy_(0, k, self.theta[None])
        for dst, src in zip(state_tensors(self.ws), state_tensors(wst)):
            dst.index_copy_(0, k, src[None])
        self.losses.index_copy_(0, e, loss.detach().reshape(1).to(
            torch.float32))
        if self.up_nnz is not None:
            self.up_nnz.index_copy_(0, e, torch.count_nonzero(msg)[None])
        if self.down_nnz is not None:
            self.down_nnz.index_copy_(0, e, torch.count_nonzero(G)[None])
        if self.ms is not None:
            # reads the SHIPPED messages only, after the data plane
            metrics_lib.fold_(self.ms, k, self.staleness.index_select(0, e),
                              metrics_lib.msg_nnz(msg),
                              metrics_lib.msg_nnz(G),
                              metrics_lib.msg_sqnorm(G))
        e.add_(1)


def _capture(event: _Event, n_events: int, rec):
    """Event 0 eagerly on a side stream, then ONE capture of the event
    (unless it was the only one).  Returns ``(graph, launches)``: the
    graph (None for one event) and the launches one replay makes."""
    from repro_torch.kernels import build

    dev = event.theta.device
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(device=dev)
    graph = launches = None
    with rec.span("scan/capture"):
        side.wait_stream(main)
        with torch.cuda.stream(side):
            event()
        if n_events > 1:
            graph = torch.cuda.CUDAGraph()
            with build.recording() as launches, \
                    torch.cuda.graph(graph, stream=side):
                event()
        main.wait_stream(side)
    return graph, launches


def run_async_scan_with_state(
    strategy: Strategy,
    grad_fn,
    params0,
    schedule,
    batches,
    *,
    n_workers: int,
    lr: float,
    secondary_density: float | None = None,
    secondary_spec: CompressionSpec = engine_lib.EXACT_SPEC,
    recorder=None,
    metrics: bool = False,
    device=None,
):
    """:func:`run_async_scan`, returning ``(final global model, server
    state, History)``: the server state's ``M`` and ``v`` are the arenas
    the run updated in place."""
    rec = recorder if recorder is not None else telemetry.NULL
    dev = resolve_device(device)
    schedule = np.asarray(schedule)
    n_events = len(schedule)
    params0 = async_sim._to_device(params0, dev)
    batches = _tree_map(lambda b: torch.as_tensor(b).to(dev), batches)
    space = ParamSpace.from_tree(params0)
    sstate = ps.init(params0, n_workers)
    wp = space.pack(params0).expand(n_workers, -1).contiguous()
    ws = state_map(lambda s: s.expand(n_workers, *s.shape).contiguous(),
                   strategy.init(params0))
    stal = async_sim.staleness_of(schedule, n_workers)
    ms = metrics_lib.init(n_workers, dev) if metrics else None
    event = _Event(strategy, grad_fn, space, sstate, wp, ws, schedule,
                   batches, lr, secondary_density, secondary_spec, ms, stal)

    graph, todo = None, n_events
    if dev.type == "cuda" and n_events:
        graph, launches = _capture(event, n_events, rec)
        todo = n_events - 1
    with rec.span("scan/execute"):
        for _ in range(todo):
            if graph is None:
                event()
            else:
                graph.replay()
                launches.replay()
    # the run's one host sync, while the graph lives
    losses = event.losses.cpu().numpy().astype(np.float64)
    up_nnz, down_nnz = (None if t is None else t.cpu().numpy()
                        for t in (event.up_nnz, event.down_nnz))
    sstate = sstate._replace(t=n_events)

    def per_event(seg, mode, nnz):
        if seg is not None:  # static sparse frames: no device data needed
            return np.full(n_events,
                           wire.frame_bytes_static(seg, space.total, mode))
        return wire.ENVELOPE_BYTES + wire.dense_frame_bytes(nnz, space.total)

    per_up = per_event(event.up_seg, event.up_mode, up_nnz)
    per_down = per_event(event.down_seg, event.down_mode, down_nnz)
    hist = async_sim.History(
        losses=losses,
        worker_ids=schedule,
        staleness=stal,
        up_bytes=int(np.sum(per_up)),
        down_bytes=int(np.sum(per_down)),
        evals=[],
        metrics=metrics_lib.drain(ms) if ms is not None else None,
    )
    async_sim._record_run_summary(rec, "scan", hist, None, None, per_up,
                                  per_down)
    return ps.global_model(params0, sstate), sstate, hist


def run_async_scan(
    strategy: Strategy,
    grad_fn,
    params0,
    schedule,
    batches,
    *,
    n_workers: int,
    lr: float,
    secondary_density: float | None = None,
    secondary_spec: CompressionSpec = engine_lib.EXACT_SPEC,
    recorder=None,
    metrics: bool = False,
    device=None,
):
    """Run the whole schedule: on the card as ONE captured CUDA graph of
    the event, replayed once per event; on the CPU the same event eagerly.

    schedule: ``(n_events,)`` worker ids.
    batches:  a tree (dict, tuple) stacked on a leading ``n_events`` axis;
              event e's batch is each leaf's row e.
    device:   where the run lives; None means the card.
    Returns ``(final global model, History)``, the History carrying the
    losses, staleness and byte totals ``AsyncTrainer.run`` gives.

    ``lr`` is a float, baked into the graph as ``run`` bakes it into each
    step.  ``metrics=True`` folds every event into an on-device
    :class:`~repro_torch.telemetry.metrics.MetricsState` inside the graph,
    reading only the shipped messages, so no data-plane bit changes;
    ``recorder`` gets the spans ``scan/capture`` (the first, eager event
    and the capture) and ``scan/execute`` (the replays as the host enqueues
    them; on the CPU every event) and the run summary.
    """
    final, _, hist = run_async_scan_with_state(
        strategy, grad_fn, params0, schedule, batches, n_workers=n_workers,
        lr=lr, secondary_density=secondary_density,
        secondary_spec=secondary_spec, recorder=recorder, metrics=metrics,
        device=device)
    return final, hist
