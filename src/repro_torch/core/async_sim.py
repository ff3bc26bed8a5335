"""Deterministic event-driven simulator for asynchronous PS training
(PyTorch port of ``repro.core.async_sim``).

Every worker owns a local model arena and strategy state; a schedule of
worker ids (from simulated heterogeneous speeds) fixes the order in which
workers reach the server.  Each event runs four stages -- client compute,
server receive + select, server commit, worker apply -- with the wire
quantizer between them, exactly as the reference decomposes them.

Two event loops share those stages:

* ``AsyncTrainer.run``          -- serial: one event at a time.
* ``AsyncTrainer.run_batched``  -- ``batch_schedule`` groups runs of
  PAIRWISE-DISTINCT workers.  The client stage calls ``grad_fn`` once per
  lane and then steps the whole batch's strategy rows at once (one launch
  of each kernel per leaf); the server's receives and selects stay a
  sequential loop (event i's select must see the M that events 0..i
  left); the commits and the applies each fold the whole batch into their
  distinct rows with ONE multi-row scatter (kernel 4).  Bit for bit equal
  to the serial loop: losses, params, ``M``, ``v`` and bytes.

Everything runs on ``AsyncTrainer.device``: the card unless the caller asks
for the CPU (``device="cpu"``, as the tests do).  There is no silent
fallback: without CUDA, the default device raises.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.cluster import wire
from repro_torch.device import from_host, resolve_device
from repro_torch.telemetry import metrics as metrics_lib

from . import engine as engine_lib
from . import server as ps
from .baselines import Strategy, state_map, state_tensors
from .engine import CompressionSpec
from .paramspace import ParamSpace, tree_flatten, tree_leaves, tree_unflatten
from .sparsify import SparseLeaf


def make_schedule(n_workers: int, n_events: int, *, seed: int = 0,
                  hetero: float = 0.5) -> np.ndarray:
    """Event order from simulated worker speeds: exponential service times
    with per-worker rates drawn lognormal(0, hetero); ties resolve to the
    lowest worker id.  Pure numpy, identical to the reference."""
    rng = np.random.default_rng(seed)
    speeds = np.exp(rng.normal(0.0, hetero, n_workers))
    scale = 1.0 / speeds
    t_next = rng.exponential(scale)
    heap = [(float(t_next[k]), k) for k in range(n_workers)]
    heapq.heapify(heap)
    order = np.empty(n_events, dtype=np.int32)
    for e in range(n_events):
        t, k = heapq.heappop(heap)
        order[e] = k
        heapq.heappush(heap, (t + rng.exponential(scale[k]), k))
    return order


def staleness_of(schedule, n_workers: int) -> np.ndarray:
    """Per-event staleness (server updates since the worker last synced)."""
    last_sync = np.zeros(n_workers, dtype=np.int64)
    out = np.zeros(len(schedule), dtype=np.int64)
    for e, k in enumerate(schedule):
        out[e] = e - last_sync[k]
        last_sync[k] = e + 1
    return out


def batch_schedule(schedule, *, max_batch: int | None = None,
                   cut_every: int | None = None) -> list[np.ndarray]:
    """Group a schedule into batches of independent events.

    A batch is a maximal run of CONSECUTIVE events with pairwise-distinct
    workers, truncated to a power-of-two length: every event of it reads a
    different worker model and commits to a different ``v`` row.
    ``cut_every`` forces batch boundaries at multiples of that many events
    (evaluation points); ``max_batch`` caps the batch size.  Invariant:
    ``np.concatenate(batch_schedule(s)) == s``.  Pure numpy, identical to
    the reference.
    """
    sched = np.asarray(schedule)
    n = len(sched)
    batches = []
    i = 0
    while i < n:
        limit = n
        if cut_every:
            limit = min(limit, (i // cut_every + 1) * cut_every)
        if max_batch is not None:
            limit = min(limit, i + max_batch)
        seen = set()
        j = i
        while j < limit and sched[j] not in seen:
            seen.add(sched[j])
            j += 1
        size = 1 << ((j - i).bit_length() - 1)   # pow2 truncation
        batches.append(sched[i:i + size])
        i += size
    return batches


class History(NamedTuple):
    losses: np.ndarray          # (n_events,)
    worker_ids: np.ndarray      # (n_events,)
    staleness: np.ndarray       # (n_events,)
    up_bytes: int               # total upward wire bytes
    down_bytes: int             # total downward wire bytes
    evals: list                 # [(event_idx, metric), ...]
    # drained telemetry metrics when the run collected them, else None;
    # the data plane is identical either way
    metrics: dict | None = None


def _jsonable(x):
    """Best-effort scalarization of an eval metric for the JSONL log."""
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)


def _record_run_summary(rec, runner: str, hist: History,
                        up_cost, down_cost, per_up, per_down) -> None:
    """Emit the end-of-run JSONL summary: staleness and per-event wire-byte
    histograms (host data only: the run is over, so this syncs nothing)."""
    if not rec.enabled:
        return
    n = len(hist.losses)
    if per_up is None:
        per_up = np.full(n, up_cost if up_cost is not None else 0)
    if per_down is None:
        per_down = np.full(n, down_cost if down_cost is not None else 0)
    rec.event(
        "run_summary", runner=runner, n_events=n,
        up_bytes=int(hist.up_bytes), down_bytes=int(hist.down_bytes),
        loss_first=float(hist.losses[0]) if n else None,
        loss_last=float(hist.losses[-1]) if n else None,
        staleness_hist=metrics_lib.summarize_log2(hist.staleness),
        up_bytes_hist=metrics_lib.summarize_log2(per_up),
        down_bytes_hist=metrics_lib.summarize_log2(per_down),
        metrics=hist.metrics,
    )


# ---------------------------------------------------------------------------
# The four per-event stages, decomposed as the reference (and its cluster
# runtime) runs them.  Wire quantization happens BETWEEN stages via
# wire.quantize_message, never inside the strategy step.
# ---------------------------------------------------------------------------

def strip_quantize(strategy: Strategy) -> Strategy:
    """The strategy with in-engine wire quantization disabled: the wire
    owns value quantization."""
    if strategy.quantize == "none":
        return strategy
    return dataclasses.replace(strategy, quantize="none")


def client_step_fn(strategy: Strategy, grad_fn, space: ParamSpace):
    """Client compute: grads on the stale local model (the arena unpacked
    to views for ``grad_fn``) + strategy step.  Returns (new strategy
    state, loss, RAW upward message)."""
    strategy = strip_quantize(strategy)

    def client_step(theta, wstrat, batch, lr):
        loss, grads = grad_fn(space.unpack(theta), batch)
        wstrat, msg = strategy.step(wstrat, grads, lr)
        return wstrat, loss, msg

    return client_step


def server_step_fn(secondary_density, spec: CompressionSpec):
    """Server: apply the upward message (M in place), select the RAW
    downward one."""

    def server_step(sstate, msg, worker_id):
        sstate = ps.receive(sstate, msg)
        G = ps.send_select(sstate, worker_id,
                           secondary_density=secondary_density, spec=spec)
        return sstate, G

    return server_step


# The reference wraps each stage in jax.jit; PyTorch runs eagerly, so the
# factories hand out the stage callables themselves.
make_client_step = client_step_fn
make_server_step = server_step_fn


def make_commit():
    """Server commit: fold the SHIPPED downward message into v_k (in
    place)."""
    return ps.send_commit


def make_apply():
    """Worker apply: theta <- theta + G (Eq. 5), in place."""
    return ps.apply_update


# ---------------------------------------------------------------------------
# Batched stages (run_batched).  Worker models and strategy states live
# STACKED -- wp: (n_workers, total), each strategy tensor (n_workers, total)
# -- and every stage takes the batch's worker ids as a host array (checked
# distinct by the scatter wrapper) and, where it indexes rows on the device,
# their device copy.  Each row of each stage's result is bit for bit what
# the serial stage gives that event.
# ---------------------------------------------------------------------------

def make_batched_client_step(strategy: Strategy, grad_fn, space: ParamSpace):
    """Client compute over a batch of distinct workers.

    ``grad_fn`` runs once per lane (a torch-autograd grad_fn does not
    batch, and a batched matmul would round otherwise than the serial
    one), on a copy of the lane's model: the copy is laid out like the
    serial loop's own theta, so a matmul library that picks its kernel by
    operand alignment picks the same one.  The grads are packed into one
    ``(B, total)`` buffer and ONE ``strategy.step_rows`` steps every lane;
    the new strategy rows are written back in place.  Returns (stacked
    state, losses (B,), RAW stacked upward message, per-lane nnz of a dense
    message or None).
    """
    strategy = strip_quantize(strategy)
    dense_msg = not strategy.sparse

    def client(wp, ws, ids, ids_dev, batches, lrs):
        g2d = torch.empty((len(ids), space.total), dtype=torch.float32,
                          device=wp.device)
        losses = []
        for i, k in enumerate(ids):
            theta = wp[int(k)].clone()
            loss, grads = grad_fn(space.unpack(theta), batches[i])
            torch.cat([leaf.reshape(-1).to(torch.float32)
                       for leaf in tree_leaves(grads)], out=g2d[i])
            losses.append(loss.detach())
        st = state_map(lambda s: s.index_select(0, ids_dev), ws)
        st, msgs = strategy.step_rows(st, g2d, lrs, space)
        for dst, src in zip(state_tensors(ws), state_tensors(st)):
            dst.index_copy_(0, ids_dev, src)
        nnz = (msgs != 0.0).sum(dim=1) if dense_msg else None
        return ws, torch.stack(losses), msgs, nnz

    return client



def make_batched_quantize(mode: str, seg):
    """Row-wise wire quantization of a stacked sparse message (one scale
    per row per segment), or None when it is a no-op (mode "none", or
    dense messages, which travel f32)."""
    if mode == "none" or seg is None:
        return None
    seg = tuple(int(s) for s in seg)
    return lambda msgs: wire.quantize_message(msgs, mode, seg=seg)


def make_batched_server_step(secondary_density, spec: CompressionSpec):
    """Server over a whole batch: receive each message and select each RAW
    downward message against the M its predecessors left -- a sequential
    loop of the serial server stage, one scatter (kernel 1) and one select
    per event.  The ``v`` rows it reads are untouched within the batch
    (distinct workers).

    Returns ``(sstate, G, M_rows)``: G the stacked raw downward batch;
    ``M_rows`` the ``(B, total)`` stack of each event's M when the downward
    message is dense (the commit snaps ``v_k`` to M as of that event), else
    None.
    """
    server_step = server_step_fn(secondary_density, spec)
    dense_down = secondary_density is None

    def server_batch(sstate, msgs, ids):
        Gs, M_rows = [], []
        for i, k in enumerate(ids):
            msg = msgs.row(i) if isinstance(msgs, SparseLeaf) else msgs[i]
            sstate, G = server_step(sstate, msg, int(k))
            Gs.append(G)
            if dense_down:
                M_rows.append(sstate.M.clone())
        return (sstate, *_stack_down(Gs, M_rows))

    return server_batch


def _stack_down(Gs, M_rows):
    """A batch's downward messages and (dense down) its M prefixes,
    stacked: ``(G, M_rows)``, ``M_rows`` None for a sparse batch."""
    if M_rows:
        return torch.stack(Gs), torch.stack(M_rows)
    return SparseLeaf(values=torch.stack([G.values for G in Gs]),
                      indices=torch.stack([G.indices for G in Gs]),
                      size=Gs[0].size), None


def make_batched_commit(dense_down: bool):
    """Batched commit: the SHIPPED batch into its ``v`` rows with ONE
    multi-row scatter (``server.send_commit_rows``), in place.  The dense
    variant takes the server stage's prefix ``M_rows`` and also returns
    each event's downward nnz for the byte count."""
    if dense_down:
        def commit(sstate, ids, G, M_rows):
            sstate = ps.send_commit_rows(sstate, ids, G, M_rows)
            return sstate, (G != 0.0).sum(dim=1)
    else:
        def commit(sstate, ids, G):
            return ps.send_commit_rows(sstate, ids, G)
    return commit


# ---------------------------------------------------------------------------
# The mesh server's batched stages: the same call signatures and outputs as
# the flat ones above, on a ``server.MeshServerState``.  A batch's messages
# reach their shards through the route exchange
# (``distributed.shard_exchange_batch``); the shard scatters are kernel row
# 2 (``scatter_add_rows``) with one lane per shard row, which drops the
# ``-1`` of an empty slot, and the reads of ``v`` are per-event views, so no
# ``(B, S, width)`` copy of it is made.
# ---------------------------------------------------------------------------

def mesh_batched_server_step_fn(secondary_density, spec: CompressionSpec):
    """The mesh twin of :func:`make_batched_server_step`: ALL S shard
    servers in one stage.  A sparse upward batch is routed once; each
    event then applies one S-lane scatter into the stacked ``(S, width)``
    M, in place, and selects on the re-concatenated GLOBAL diff through
    the same ``ParamSpace.select``, so the downward message and its wire
    bytes are the flat server's.  Returns ``(sstate, G, M_rows)``, with
    ``M_rows`` the ``(B, S, width)`` mesh prefixes of a dense downward
    batch, else None."""
    from repro_torch.kernels import ops

    from . import distributed

    dense_down = secondary_density is None
    spec_raw = dataclasses.replace(spec, quantize="none")

    def server_batch(sstate, msgs, ids):
        sspec, M = sstate.spec, sstate.M
        sparse_up = isinstance(msgs, SparseLeaf)
        if sparse_up:
            ri, rv, ovf = distributed.shard_exchange_batch(
                sspec, msgs.indices, msgs.values)      # (B, S, slots)
            neg = -rv
        else:
            ovf = 0
        Gs, M_rows = [], []
        for i, k in enumerate(ids):
            if sparse_up:
                ops.scatter_add_rows(M, None, ri[i], neg[i])
            else:
                M.sub_(ps.mesh_split(sspec, msgs[i], M.shape[1]))
            diff = ps.mesh_concat(sspec, M - sstate.v[int(k)])
            if dense_down:
                Gs.append(diff)
                M_rows.append(M.clone())
            else:
                Gs.append(sstate.space.select(
                    diff, sstate.space.ks(secondary_density), spec_raw))
        sstate = sstate._replace(t=sstate.t + len(ids),
                                 overflow=sstate.overflow + ovf)
        return (sstate, *_stack_down(Gs, M_rows))

    return server_batch


make_mesh_batched_server_step = mesh_batched_server_step_fn


def make_mesh_batched_commit(dense_down: bool):
    """The mesh twin of :func:`make_batched_commit`, in place.  A sparse
    commit routes the SHIPPED batch through the same exchange as the
    receive and lands it in ``v`` with ONE multi-row scatter of ``B * S``
    lanes on ``v`` viewed as ``(n_workers * S, width)``, lane ``(b, s)`` on
    row ``ids[b] * S + s``; a dense commit snaps each ``v`` row to its
    event's ``(S, width)`` mesh prefix ``M_rows``."""
    from repro_torch.kernels import ops

    from . import distributed

    if dense_down:
        def commit(sstate, ids, G, M_rows):
            rows = from_host(np.asarray(ids, np.int64), sstate.v.device)
            sstate.v.index_copy_(0, rows, M_rows)
            return sstate, (G != 0.0).sum(dim=1)
    else:
        def commit(sstate, ids, G):
            W, S, width = sstate.v.shape
            ri, rv, ovf = distributed.shard_exchange_batch(
                sstate.spec, G.indices, G.values)     # (B, S, slots)
            rows = (np.asarray(ids, np.int64)[:, None] * S
                    + np.arange(S)).reshape(-1)
            ops.scatter_add_rows(sstate.v.view(W * S, width), rows,
                                 ri.reshape(-1, ri.shape[-1]),
                                 rv.reshape(-1, rv.shape[-1]))
            return sstate._replace(overflow=sstate.overflow + ovf)
    return commit


def _to_device(tree, device):
    leaves, paths = tree_flatten(tree)
    return tree_unflatten(paths, [l.to(device) for l in leaves])


@dataclasses.dataclass
class AsyncTrainer:
    """Asynchronous PS training loop over a gradient function.

    grad_fn(params, batch) -> (loss, grads), params and grads being dicts of
    tensors on ``device`` (None = the card).
    """

    strategy: Strategy
    grad_fn: Callable
    n_workers: int
    lr: float
    secondary_density: float | None = None
    secondary_spec: CompressionSpec = engine_lib.EXACT_SPEC
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def init(self, params0):
        params0 = _to_device(params0, self.device)
        theta0 = ParamSpace.from_tree(params0).pack(params0)
        workers = [
            # per-worker copies: apply updates each theta in place
            {"theta": theta0.clone(), "strat": self.strategy.init(params0)}
            for _ in range(self.n_workers)
        ]
        return ps.init(params0, self.n_workers), workers

    def run(self, params0, schedule: np.ndarray,
            batch_fn: Callable[[int, int], Any], *,
            lr_fn: Callable[[int], float] | None = None,
            eval_fn: Callable | None = None, eval_every: int = 0,
            recorder=None, metrics: bool = False):
        """Run the full schedule.  batch_fn(event_idx, worker_id) -> batch.
        Returns (final params, server state, History).

        ``recorder`` (a :class:`repro_torch.telemetry.Recorder`) traces
        per-event host spans and run events; ``metrics=True`` folds every
        event into an on-device :class:`~repro_torch.telemetry.metrics.
        MetricsState`, drained into ``History.metrics`` at the end.  Both
        default off, and neither changes a data-plane bit.
        """
        rec = recorder if recorder is not None else telemetry.NULL
        params0 = _to_device(params0, self.device)
        space = ParamSpace.from_tree(params0)
        sstate, workers = self.init(params0)
        client_step = make_client_step(self.strategy, self.grad_fn, space)
        server_step = make_server_step(self.secondary_density,
                                       self.secondary_spec)
        commit, apply_G = make_commit(), make_apply()
        up_mode = self.strategy.quantize
        down_mode = self.secondary_spec.quantize
        up_seg = self.strategy.message_seg(space)
        down_seg = (space.ks(self.secondary_density)
                    if self.secondary_density is not None else None)
        # sparse frame sizes are static per (mode, seg, total); dense ones
        # depend on the nonzero count, kept on the device until the end
        up_cost = (wire.frame_bytes_static(up_seg, space.total, up_mode)
                   if up_seg is not None else None)
        down_cost = (wire.frame_bytes_static(down_seg, space.total, down_mode)
                     if down_seg is not None else None)
        losses: list = []
        up_nnz: list = []
        down_nnz: list = []
        up_bytes = down_bytes = 0
        evals = []
        stal = staleness_of(schedule, self.n_workers)
        ms = metrics_lib.init(self.n_workers, self.device) if metrics else None
        mstep = metrics_lib.make_metrics_step() if metrics else None
        for e, k in enumerate(schedule):
            k = int(k)
            lr = self.lr if lr_fn is None else float(lr_fn(e))
            with rec.span("sim/batch_build", worker=k):
                batch = batch_fn(e, k)
            with rec.span("sim/client_step", worker=k):
                wst, loss, msg = client_step(
                    workers[k]["theta"], workers[k]["strat"], batch, lr)
            with rec.span("sim/wire_quantize"):
                msg = wire.quantize_message(msg, up_mode, seg=up_seg)
            with rec.span("sim/server_step"):
                sstate, G = server_step(sstate, msg, k)
                G = wire.quantize_message(G, down_mode, seg=down_seg)
            with rec.span("sim/commit"):
                sstate = commit(sstate, k, G)
            with rec.span("sim/apply"):
                workers[k]["theta"] = apply_G(workers[k]["theta"], G)
            workers[k]["strat"] = wst
            losses.append(loss.detach())
            if ms is not None:
                # reads the SHIPPED messages only; no host sync
                ms = mstep(ms, k, stal[e], msg, G)
            if up_cost is not None:
                up_bytes += up_cost
            else:
                up_nnz.append(torch.count_nonzero(msg))
            if down_cost is not None:
                down_bytes += down_cost
            else:
                down_nnz.append(torch.count_nonzero(G))
            if eval_fn is not None and eval_every and (e + 1) % eval_every == 0:
                with rec.span("sim/eval", event=e + 1):
                    evals.append((e + 1, eval_fn(ps.global_model(params0,
                                                                 sstate))))
                rec.event("eval", event=e + 1, metric=_jsonable(evals[-1][1]),
                          **({"metrics": metrics_lib.drain(ms)}
                             if ms is not None else {}))
        final = ps.global_model(params0, sstate)
        per_up = per_down = None
        if up_nnz:
            per_up = wire.ENVELOPE_BYTES + wire.dense_frame_bytes(
                torch.stack(up_nnz).cpu().numpy(), space.total)
            up_bytes += int(np.sum(per_up))
        if down_nnz:
            per_down = wire.ENVELOPE_BYTES + wire.dense_frame_bytes(
                torch.stack(down_nnz).cpu().numpy(), space.total)
            down_bytes += int(np.sum(per_down))
        hist = History(
            losses=torch.stack(losses).cpu().numpy().astype(np.float64),
            worker_ids=np.asarray(schedule),
            staleness=stal,
            up_bytes=up_bytes,
            down_bytes=down_bytes,
            evals=evals,
            metrics=metrics_lib.drain(ms) if ms is not None else None,
        )
        _record_run_summary(rec, "serial", hist, up_cost, down_cost,
                            per_up, per_down)
        return final, sstate, hist

    def run_batched(self, params0, schedule: np.ndarray,
                    batch_fn: Callable[[int, int], Any], *,
                    lr_fn: Callable[[int], float] | None = None,
                    eval_fn: Callable | None = None, eval_every: int = 0,
                    max_batch: int | None = None, recorder=None,
                    metrics: bool = False):
        """Batched event loop, bit for bit equal to :meth:`run`.

        ``batch_schedule`` groups runs of pairwise-distinct workers (cut at
        the eval points, capped at ``max_batch``); each batch then costs
        one client step over all its lanes, a loop of per-event server
        steps, ONE multi-row commit and ONE multi-row apply.  Worker models
        and strategy states live stacked -- ``(n_workers, total)`` arenas --
        and are updated in place.  Losses, final params, ``M``, ``v`` and
        the wire bytes match the serial loop on the same schedule.

        ``recorder``/``metrics`` mirror :meth:`run`: host spans per batch,
        one metrics fold per batch, no host sync, no data-plane change.
        """
        rec = recorder if recorder is not None else telemetry.NULL
        params0 = _to_device(params0, self.device)
        space = ParamSpace.from_tree(params0)
        sstate = ps.init(params0, self.n_workers)
        n = self.n_workers
        wp = space.pack(params0).expand(n, -1).contiguous()
        ws = state_map(lambda s: s.expand(n, *s.shape).contiguous(),
                       self.strategy.init(params0))
        client = make_batched_client_step(self.strategy, self.grad_fn, space)
        server = make_batched_server_step(self.secondary_density,
                                          self.secondary_spec)
        dense_down = self.secondary_density is None
        commit = make_batched_commit(dense_down)
        up_mode = self.strategy.quantize
        down_mode = self.secondary_spec.quantize
        up_seg = self.strategy.message_seg(space)
        down_seg = None if dense_down else space.ks(self.secondary_density)
        q_up = make_batched_quantize(up_mode, up_seg)
        q_down = make_batched_quantize(down_mode, down_seg)
        up_cost = (wire.frame_bytes_static(up_seg, space.total, up_mode)
                   if up_seg is not None else None)
        down_cost = (wire.frame_bytes_static(down_seg, space.total, down_mode)
                     if down_seg is not None else None)

        batches = batch_schedule(schedule, max_batch=max_batch,
                                 cut_every=eval_every or None)
        stal = staleness_of(schedule, self.n_workers)
        ms = metrics_lib.init(self.n_workers, self.device) if metrics else None
        mstep = metrics_lib.make_metrics_step() if metrics else None
        losses, up_nnz, down_nnz, evals = [], [], [], []
        e = 0
        for ids in batches:
            b = len(ids)
            lrs = np.asarray([self.lr if lr_fn is None else float(lr_fn(e + i))
                              for i in range(b)], np.float32)
            with rec.span("batched/batch_build", size=b):
                data = [batch_fn(e + i, int(k)) for i, k in enumerate(ids)]
            with rec.span("batched/client", size=b):
                ids_dev = from_host(ids.astype(np.int64), self.device)
                ws, batch_losses, msgs, nnz_up = client(
                    wp, ws, ids, ids_dev, data, from_host(lrs, self.device))
                if q_up is not None:
                    msgs = q_up(msgs)
            with rec.span("batched/server", size=b):
                sstate, G, M_rows = server(sstate, msgs, ids)
            with rec.span("batched/commit", size=b):
                if dense_down:
                    sstate, nnz_dn = commit(sstate, ids, G, M_rows)
                    down_nnz.append(nnz_dn)
                else:
                    if q_down is not None:
                        G = q_down(G)
                    sstate = commit(sstate, ids, G)
            with rec.span("batched/apply", size=b):
                ps.apply_update_rows(wp, ids, G)
            losses.append(batch_losses)
            if ms is not None:
                ms = mstep(ms, ids, stal[e:e + b], msgs, G)
            if up_cost is None:
                up_nnz.append(nnz_up)
            e += b
            if eval_fn is not None and eval_every and e % eval_every == 0:
                with rec.span("batched/eval", event=e):
                    evals.append((e, eval_fn(ps.global_model(params0,
                                                             sstate))))
                rec.event("eval", event=e, metric=_jsonable(evals[-1][1]),
                          **({"metrics": metrics_lib.drain(ms)}
                             if ms is not None else {}))
        final = ps.global_model(params0, sstate)
        n_events = len(schedule)
        per_up = per_down = None
        if up_cost is not None:
            up_bytes = up_cost * n_events
        else:
            per_up = wire.ENVELOPE_BYTES + wire.dense_frame_bytes(
                torch.cat(up_nnz).cpu().numpy(), space.total)
            up_bytes = int(np.sum(per_up))
        if down_cost is not None:
            down_bytes = down_cost * n_events
        else:
            per_down = wire.ENVELOPE_BYTES + wire.dense_frame_bytes(
                torch.cat(down_nnz).cpu().numpy(), space.total)
            down_bytes = int(np.sum(per_down))
        hist = History(
            losses=torch.cat(losses).cpu().numpy().astype(np.float64),
            worker_ids=np.asarray(schedule),
            staleness=stal,
            up_bytes=up_bytes,
            down_bytes=down_bytes,
            evals=evals,
            metrics=metrics_lib.drain(ms) if ms is not None else None,
        )
        _record_run_summary(rec, "batched", hist, up_cost, down_cost,
                            per_up, per_down)
        return final, sstate, hist
