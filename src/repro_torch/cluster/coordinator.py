"""The coordinator: ``core/server.py``'s model-difference state behind a
wire (PyTorch port of ``repro.cluster.coordinator``).

One asynchronous PS loop over any :mod:`repro_torch.cluster.transport`
backend.  Per batch of upward messages the coordinator runs the SAME
batched server stages as ``AsyncTrainer.run_batched``
(``make_batched_server_step`` / ``make_batched_commit``), with the wire
codec between them:

    UP frames -> decode -> receive + send_select, per event
              -> encode DOWN (the codec quantizes in flight, one launch)
              -> commit the codec's *shipped* leaves (one multi-row scatter)
              -> DOWN frames

so the server's v_k always tracks exactly the bits the client decoded, and
a schedule-driven run reproduces the simulator bit for bit.

Federated behaviours:

* elastic membership -- HELLO assigns a worker slot (reusing freed slots,
  growing ``v`` via ``server.add_worker`` when none are free); BYE zeroes
  the slot for the next joiner.
* partial participation -- SKIP frames advance a client's virtual clock
  without touching server state.
* at-least-once delivery -- duplicate UP ``seq`` numbers (client retries
  after a dropped frame) are answered from a per-client reply cache
  without re-applying the gradient.
* measured bytes -- ``History.up_bytes``/``down_bytes`` are the actual
  serialized frame sizes moved through the transport.

The serve leg: inference replicas SUBscribe and PULL coalesced
re-sparsified model diffs while training runs, and SYNC to the bit-exact
final model (``cluster/subscribe.py``); their bytes stay out of
``up_bytes``/``down_bytes``.  ``ckpt_dir`` appends delta checkpoints of the
live arena ``theta_0 + M`` (``checkpoint/delta.py``).  Both compute on the
coordinator's device.

Sharded parameter servers, two runtimes:

* ``shard_spec``/``shard_id`` -- this coordinator is one of S shard
  coordinators, each an ordinary coordinator over the contiguous arena
  range ``shard_spec.bounds[shard_id:shard_id+2]``: its server state,
  stages, seg tables and wire frames are over THAT sub-arena (a leaf-aligned
  shard is itself a complete, smaller parameter arena, possibly empty).
* ``mesh_shards = S`` -- ONE coordinator hosts all S shard arenas stacked
  (``server.MeshServerState``) and serves them through the mesh stages,
  which route every message through ``distributed.shard_exchange_batch``;
  its wire protocol is the single server's, so up/down bytes equal it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import async_sim, engine as engine_lib
from repro_torch.core import server as ps
from repro_torch.core.engine import CompressionSpec
from repro_torch.core.paramspace import tree_leaves
from repro_torch.core.sparsify import SparseLeaf
from repro_torch.telemetry import metrics as metrics_lib

from . import subscribe, wire
from .client import AUTO_SLOT
from .transport import RecvTimeout


def _stack(leaves):
    """Stack a batch of messages on a leading axis."""
    if isinstance(leaves[0], SparseLeaf):
        return SparseLeaf(values=torch.stack([m.values for m in leaves]),
                          indices=torch.stack([m.indices for m in leaves]),
                          size=leaves[0].size)
    return torch.stack(leaves)


@dataclasses.dataclass
class Coordinator:
    """Parameter-server side of the cluster runtime; computes on the device
    of ``params0``."""

    transport: Any
    params0: Any
    n_slots: int
    secondary_density: float | None = None
    secondary_spec: CompressionSpec = engine_lib.EXACT_SPEC
    scheduler: Any = None              # ScheduleDriven | VirtualClock | None
    virtual_costs: dict | None = None  # client -> FaultPolicy (virtual time)
    recv_timeout: float | None = None
    # upper bound on how many scheduler turns drain as ONE batched server
    # pass (None = unbounded, 1 = serve serially).  Only schedulers with
    # ``next_batch`` (ScheduleDriven) batch; the batched stages are
    # bit-equal to the serial ones, so this is purely a speed knob.
    max_batch: int | None = None
    recorder: Any = None               # telemetry.Recorder (None = no-op)
    # the S-thread sharded server: this coordinator owns the arena range
    # shard_spec.bounds[shard_id:shard_id+2] (a leaf-aligned ShardSpec)
    shard_spec: Any = None             # paramspace.ShardSpec | None
    shard_id: int = 0
    # the mesh server: ONE coordinator hosts all S shard arenas, stacked;
    # exclusive with shard_spec
    mesh_shards: int = 0
    # serve leg: inference replicas SUBscribe and PULL coalesced
    # re-sparsified model diffs while training runs.  ``push_density``
    # picks the per-tensor top-k of each push (None = ship the exact
    # nonzero residual), ``push_spec`` the engine and wire quantization.
    # ``min_subscribers`` keeps the coordinator serving until that many
    # replicas have subscribed AND left, closing the race where a short
    # run quiesces before TCP replicas connect.
    push_density: float | None = None
    push_spec: CompressionSpec = engine_lib.EXACT_SPEC
    min_subscribers: int = 0
    # delta checkpoints: append the live arena every ``ckpt_every`` served
    # events (0 = the final state only)
    ckpt_dir: Any = None
    ckpt_every: int = 0

    def __post_init__(self):
        if self.recorder is None:
            self.recorder = telemetry.NULL
        self._device = tree_leaves(self.params0)[0].device
        if self.shard_spec is not None:
            self._params0_local = self.shard_spec.shard_tree(self.params0,
                                                             self.shard_id)
        else:
            self._params0_local = self.params0
        if self.mesh_shards:
            if self.shard_spec is not None:
                raise ValueError("mesh_shards and shard_spec are two "
                                 "different sharding runtimes: pass one")
            self.sstate = ps.init_mesh_shards(self.params0, self.n_slots,
                                              self.mesh_shards)
            self._batched_server = async_sim.make_mesh_batched_server_step(
                self.secondary_density, self.secondary_spec)
            self._commit_rows = async_sim.make_mesh_batched_commit(
                self.secondary_density is None)
        else:
            self.sstate = ps.init(self._params0_local, self.n_slots,
                                  self._device)
            self._batched_server = async_sim.make_batched_server_step(
                self.secondary_density, self.secondary_spec)
            self._commit_rows = async_sim.make_batched_commit(
                self.secondary_density is None)
        self._down_mode = self.secondary_spec.quantize
        # arena frame segmentation of the sparse downward message (None =
        # dense downward, framed DENSE/DENSE_COO)
        self._down_seg = (self.sstate.space.ks(self.secondary_density)
                          if self.secondary_density is not None else None)
        self._free = list(range(self.n_slots))
        self._slot_of: dict[int, int] = {}
        self._last_seq: dict[int, int] = {}
        self._reply_cache: dict[int, bytes] = {}
        self._joined: set[int] = set()
        self._left: set[int] = set()
        self._losses: list[float] = []
        self._served_slots: list[int] = []
        self._staleness: list[int] = []
        self._last_sync: dict[int, int] = {}
        self.up_bytes = 0
        self.down_bytes = 0
        # flight-recorder accounting: message-kind and per-client counters
        # and per-event frame sizes, all host-side ints.  The shard-balance
        # rows: how much of the arena this coordinator holds (a mesh
        # coordinator holds every shard)
        self.counters: dict[str, float] = {}
        if self.mesh_shards:
            for s, sz in enumerate(self.sstate.spec.sizes):
                self.counters[f"shard/{s}/arena_elems"] = sz
        else:
            self.counters[f"shard/{self.shard_id}/arena_elems"] = \
                self.sstate.space.total
        self._up_sizes: list[int] = []
        self._down_sizes: list[int] = []
        self.batch_sizes: list[int] = []   # events per server pass
        # serve leg state: per-subscriber cursor arenas and the live-arena
        # delta-checkpoint chain, all on the coordinator's device
        self.book = subscribe.SubscriberBook(
            self.sstate.space, push_density=self.push_density,
            push_spec=self.push_spec, device=self._device)
        self._training_over = False
        self._theta0_arena = self.sstate.space.pack(
            self._params0_local).to(self._device)
        self._ckpt = None
        self._ckpt_last = 0
        if self.ckpt_dir is not None:
            from repro_torch.checkpoint import DeltaCheckpointWriter
            self._ckpt = DeltaCheckpointWriter(
                self.ckpt_dir, self._theta0_arena, version=0,
                meta={"n_slots": self.n_slots, "shard_id": self.shard_id})

    def _count(self, name: str, n: float = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    # -- membership --------------------------------------------------------

    def _attach(self, client: int, proposed: int) -> int:
        if proposed != AUTO_SLOT and proposed in self._free:
            self._free.remove(proposed)
            slot = proposed
        elif self._free:
            slot = self._free.pop(0)
        else:
            self.sstate, slot = ps.add_worker(self.sstate)
        self._slot_of[client] = slot
        self._last_seq[client] = -1
        # a rejoining client id must not inherit the previous tenant's
        # cached reply (its seq numbers restart at 0)
        self._reply_cache.pop(client, None)
        self._joined.add(client)
        self._last_sync.setdefault(slot, 0)
        return slot

    def _detach(self, client: int):
        slot = self._slot_of.pop(client, None)
        if slot is not None:
            self.sstate = ps.reset_worker(self.sstate, slot)
            self._free.append(slot)
            self._last_sync.pop(slot, None)
        # a departed client never retransmits: drop its dedup state
        self._reply_cache.pop(client, None)
        self._last_seq.pop(client, None)
        self._left.add(client)
        if self.scheduler is not None:
            self.scheduler.deactivate(client)

    # -- one message -------------------------------------------------------

    def _classify(self, src: int, payload: bytes):
        """Decode and dispatch control traffic; returns ``(kind, msg)``.

        UP frames are only *validated* here -- the gradient math runs in
        :meth:`_process_ups`, which takes a whole batch of them at once.
        """
        try:
            msg = wire.decode_message(payload, device=self._device)
        except Exception:
            if self.scheduler is not None:
                raise   # trusted in-process peers: corruption is a bug
            self._count("ignored")
            return "ignored", None  # TCP: drop the bad frame, keep serving
        if msg.type == wire.HELLO:
            slot = self._attach(src, msg.seq)
            reply, _ = wire.encode_message(
                wire.WELCOME, wire.COORDINATOR_ID, slot)
            self.transport.send(src, reply)
            self._count("hello")
            return "hello", msg
        if msg.type == wire.SKIP:
            self._account(src, 0)
            self._count("skip")
            return "skip", msg
        if msg.type == wire.BYE:
            self._detach(src)
            self._count("bye")
            return "bye", msg
        if msg.type in (wire.SUB, wire.PULL, wire.SYNC):
            self._subscriber_msg(src, msg)
            return "sub", msg
        if msg.type != wire.UP:
            raise ValueError(f"unexpected {wire.TYPE_NAMES[msg.type]}")
        if len(msg.leaves) != 1 or src not in self._slot_of:
            # the arena protocol ships exactly ONE frame per UP message; an
            # UP without a completed HELLO comes from a restarted or foreign
            # peer: reject the frame, not the whole run
            self._count("ignored")
            return "ignored", None
        if msg.seq <= self._last_seq.get(src, -1):
            # duplicate after a dropped reply: answer from cache, do NOT
            # re-apply the gradient (at-least-once -> exactly-once)
            self._count("dup")
            self._count(f"client/{src}/dups")
            cached = self._reply_cache.get(src)
            if cached is not None:
                self._count("reply_cache_hits")
                self.transport.send(src, cached)
            return "dup", None
        return "up", msg

    def _process_ups(self, ups):
        """Apply a batch of UP messages as ONE pass over the server stages.

        ``ups`` is ``[(src, payload, msg), ...]`` with pairwise-distinct
        sources (the batching rule): the receives and selects run in order,
        each select against its prefix M, and the commits fuse into one
        multi-row scatter -- bit-equal to serving the UPs one at a time.
        Replies are sent AFTER the batch commits, in schedule order.
        """
        rec = self.recorder
        slots = [self._slot_of[src] for src, _, _ in ups]
        for (src, payload, msg), slot in zip(ups, slots):
            self.up_bytes += len(payload)
            self._up_sizes.append(len(payload))
            self._count(f"client/{src}/events")
            self._count(f"client/{src}/up_bytes", len(payload))
            # the shard-balance rows; a mesh coordinator serves every
            # shard's arena with each event, and sends ONE global frame, so
            # it has no per-shard byte rows
            if self.mesh_shards:
                for s in range(self.mesh_shards):
                    self._count(f"shard/{s}/events")
            else:
                self._count(f"shard/{self.shard_id}/events")
                self._count(f"shard/{self.shard_id}/up_bytes", len(payload))
            e = len(self._losses)
            self._losses.append(float(np.float32(msg.aux)))
            self._served_slots.append(slot)
            self._staleness.append(e - self._last_sync.get(slot, 0))
            self._last_sync[slot] = e + 1

        with rec.span("coord/server_batch", batch=len(ups)):
            stacked = _stack([m.leaves[0] for _, _, m in ups])
            self.sstate, G_stack, M_rows = self._batched_server(
                self.sstate, stacked, slots)

        with rec.span("coord/encode", batch=len(ups)):
            replies, shipped = [], []
            for i, (src, payload, msg) in enumerate(ups):
                G_i = (G_stack.row(i) if isinstance(G_stack, SparseLeaf)
                       else G_stack[i])
                reply, ship = wire.encode_message(
                    wire.DOWN, wire.COORDINATOR_ID, msg.seq, [G_i],
                    mode=self._down_mode, seg=self._down_seg)
                replies.append(reply)
                shipped.append(ship[0])

        with rec.span("coord/commit", batch=len(ups)):
            if self._down_seg is not None:
                self.sstate = self._commit_rows(self.sstate, slots,
                                                _stack(shipped))
            else:
                # dense downward: v rows snap to the per-event prefix M
                self.sstate, _ = self._commit_rows(
                    self.sstate, slots, G_stack, M_rows)

        with rec.span("coord/reply", batch=len(ups)):
            for (src, payload, msg), reply in zip(ups, replies):
                self.down_bytes += len(reply)
                self._down_sizes.append(len(reply))
                self._count(f"client/{src}/down_bytes", len(reply))
                if not self.mesh_shards:
                    self._count(f"shard/{self.shard_id}/down_bytes",
                                len(reply))
                self._last_seq[src] = msg.seq
                self._reply_cache[src] = reply
                self.transport.send(src, reply)
                self._account(src, len(payload) + len(reply))

        if rec.enabled:
            rec.event("progress", event=len(self._losses),
                      batch=len(ups), loss=self._losses[-1],
                      up_bytes=self.up_bytes, down_bytes=self.down_bytes)

        if self._ckpt is not None and self.ckpt_every and \
                self.version - self._ckpt_last >= self.ckpt_every:
            self._checkpoint()

    def _checkpoint(self):
        """Append the live arena to the delta-checkpoint chain."""
        with self.recorder.span("coord/ckpt", version=self.version):
            entry = self._ckpt.append(self._live_arena(), self.version)
        self._ckpt_last = self.version
        self._count("ckpt_deltas")
        self._count("ckpt_bytes", entry["nbytes"])

    def _M_flat(self) -> torch.Tensor:
        """The global ``(total,)`` M arena: a mesh state's shard rows
        concatenate back to it bit for bit."""
        if self.mesh_shards:
            return ps.mesh_arena(self.sstate)
        return self.sstate.M

    def _live_arena(self) -> torch.Tensor:
        """The served model's arena, ``theta_0 + M``, on the device: the
        same f32 add as ``server.global_model``, so the checkpoint chain
        restores the live model bit for bit."""
        return self._theta0_arena + self._M_flat()

    # -- serve leg ---------------------------------------------------------

    @property
    def version(self) -> int:
        """Server version: committed training events so far."""
        return len(self._losses)

    def _training_done(self) -> bool:
        """Every slot's client has joined and all have left."""
        return (len(self._joined) >= self.n_slots
                and self._joined <= self._left)

    def _quiesced(self) -> bool:
        return self._training_over or self._training_done()

    def _subscriber_msg(self, src: int, msg):
        """Serve one subscriber frame; never touches training state.

        Every reply is a DIFF whose ``seq`` is the server version and whose
        ``aux`` flags quiescence.  Push bytes land ONLY in the ``sub/{i}/*``
        counters, never in ``up_bytes``/``down_bytes``, so a
        schedule-driven run stays byte-identical to the simulator with or
        without a fleet attached.
        """
        sid = src - wire.SUBSCRIBER_BASE
        if msg.type == wire.SUB:
            if src not in self.book.subs:
                self.book.add(src)
                self._count("sub_joins")
            self._push(src, sid)     # the initial catch-up diff (v_sub = 0)
        elif src not in self.book.subs:
            self._count("ignored")
        elif msg.type == wire.PULL:
            self._push(src, sid)
        else:  # SYNC: the dense full-M handshake, then the replica leaves
            with self.recorder.span("coord/sync", sub=sid):
                payload = self.book.sync_payload(src, self._M_flat(),
                                                 self.version)
                self.transport.send(src, payload)
            self._count(f"sub/{sid}/pushes")
            self._count(f"sub/{sid}/push_bytes", len(payload))
            self.counters[f"sub/{sid}/version"] = self.version
            self._count("sub_syncs")
            self.book.drop(src)

    def _push(self, src: int, sid: int):
        version = self.version
        lag = version - self.book.subs[src].version
        with self.recorder.span("coord/push", sub=sid, lag=lag):
            payload = self.book.diff_payload(src, self._M_flat(), version,
                                             self._quiesced())
            self.transport.send(src, payload)
        self._count(f"sub/{sid}/pushes")
        self._count(f"sub/{sid}/push_bytes", len(payload))
        self.counters[f"sub/{sid}/lag_max"] = max(
            self.counters.get(f"sub/{sid}/lag_max", 0), lag)
        self.counters[f"sub/{sid}/version"] = version

    def _serve_subscriber(self, src: int, payload: bytes):
        try:
            msg = wire.decode_message(payload, device=self._device)
        except Exception:
            self._count("ignored")
            return
        self._subscriber_msg(src, msg)

    def _poll_subscribers(self):
        """Answer pending subscriber traffic without blocking, at most one
        frame per subscriber a call.  The schedule-driven loop calls this
        between turns; the transport's selective ``poll`` stashes (never
        consumes) the frames it does not accept, training clients' and a
        subscriber's next, so the served event order is untouched.  (The
        reference drains until no frame is pending: a replica that PULLs
        again as soon as its diff lands then keeps the loop from the next
        turn, and training stalls behind the pushes.)"""
        poll = getattr(self.transport, "poll", None)
        if poll is None:
            return
        served: set[int] = set()
        while (got := poll(lambda src: wire.is_subscriber(src)
                           and src not in served)) is not None:
            served.add(got[0])
            self._serve_subscriber(*got)

    def _drain_subscribers(self):
        """After training: answer PULLs with quiesced diffs until every
        subscriber (at least ``min_subscribers`` of them) has SYNCed.  A
        silence of ``recv_timeout`` raises ``RecvTimeout``."""
        while len(self.book.seen) < self.min_subscribers or self.book.subs:
            src, payload = self.transport.recv(None,
                                               timeout=self.recv_timeout)
            if wire.is_subscriber(src):
                self._serve_subscriber(src, payload)
            else:
                self._classify(src, payload)   # stray dup/bye traffic

    def _account(self, client: int, nbytes: int):
        if self.scheduler is None:
            return
        cost = 0.0
        if self.virtual_costs and client in self.virtual_costs and nbytes:
            cost = self.virtual_costs[client].frame_cost(nbytes)
            self._count(f"client/{client}/virtual_cost", cost)
        self.scheduler.account(client, cost)

    # -- the loop ----------------------------------------------------------

    def _next_turns(self, remaining: int | None) -> list[int]:
        """The scheduler's next run of turns to drain as one batch:
        ``ScheduleDriven.next_batch``'s maximal pairwise-distinct run
        (pow2-truncated); schedulers without it (VirtualClock, whose choice
        depends on costs booked per event) serve one client at a time, as
        does ``max_batch=1``."""
        next_batch = getattr(self.scheduler, "next_batch", None)
        if next_batch is None or self.max_batch == 1:
            who = self.scheduler.next_client()
            return [] if who is None else [who]
        cap = self.max_batch
        if remaining is not None:
            cap = remaining if cap is None else min(cap, remaining)
        return next_batch(cap)

    def _collect_turn(self, who):
        """One scheduler turn: absorb control traffic from ``who``'s lane
        until it yields an UP (returned unprocessed) or ends (skip/bye)."""
        while True:
            src, payload = self.transport.recv(who, timeout=self.recv_timeout)
            kind, msg = self._classify(src, payload)
            if kind == "up":
                return src, payload, msg
            if kind in ("skip", "bye"):
                return None
            # hello/dup/ignored: keep this turn open

    def serve(self, max_events: int | None = None):
        """Run until the schedule is exhausted / every client left.

        With a scheduler, each turn serves the scheduler's chosen client
        (selective receive: arrival order cannot change the served order),
        and consecutive turns for pairwise-distinct clients drain through
        the batched server stages as ONE pass (bit-equal to serial;
        ``max_batch`` caps or disables this).  Without a scheduler
        (real-time TCP mode) messages are served as they come.  Returns
        ``(final params, History)``.
        """
        events = 0
        while max_events is None or events < max_events:
            if self.scheduler is not None:
                self._poll_subscribers()
                remaining = None if max_events is None else max_events - events
                turns = self._next_turns(remaining)
                if not turns:
                    break
                ups = [up for who in turns
                       if (up := self._collect_turn(who)) is not None]
                if ups:
                    self._process_ups(ups)
                    self.batch_sizes.append(len(ups))
                    events += len(ups)
                continue
            # real-time path: one message at a time, arrival order
            try:
                src, payload = self.transport.recv(
                    None, timeout=self.recv_timeout)
            except RecvTimeout:
                if self._all_done():
                    return self._finish()
                raise
            kind, msg = self._classify(src, payload)
            if kind == "up":
                self._process_ups([(src, payload, msg)])
                self.batch_sizes.append(1)
                events += 1
            if self._all_done():
                break
        self._training_over = True
        self._drain_subscribers()
        return self._finish()

    def _all_done(self) -> bool:
        # the real-time loop ends once every slot's client has joined and
        # left (a fast client's BYE must not end a run whose other clients
        # are still connecting), the fleet has arrived (min_subscribers)
        # and every live replica has SYNCed out
        return (self._training_done()
                and len(self.book.seen) >= self.min_subscribers
                and not self.book.subs)

    def _finish(self):
        if self._ckpt is not None:
            if self._ckpt_last < self.version:
                self._checkpoint()
            self._ckpt.close()
        # a shard coordinator returns its shard's sub-tree; the runner and
        # the launcher join the shards' trees back into the full one
        final = ps.global_model(self._params0_local, self.sstate)
        if self.mesh_shards:
            # ONE read to the host, after the run: the entries the route's
            # capacity dropped (0 with the default cap)
            self.counters["route_overflow"] = int(self.sstate.overflow)
        staleness = np.asarray(self._staleness, np.int64)
        metrics = {
            "n_events": len(self._losses),
            "per_worker": np.bincount(
                np.asarray(self._served_slots, np.int64),
                minlength=self.sstate.v.shape[0]).tolist(),
            "staleness_hist": metrics_lib.summarize_log2(staleness),
            "up_bytes_hist": metrics_lib.summarize_log2(self._up_sizes),
            "down_bytes_hist": metrics_lib.summarize_log2(self._down_sizes),
            "batch_sizes": list(self.batch_sizes),
            "counters": dict(self.counters),
        }
        hist = async_sim.History(
            losses=np.asarray(self._losses, np.float64),
            worker_ids=np.asarray(self._served_slots, np.int32),
            staleness=staleness,
            up_bytes=self.up_bytes,
            down_bytes=self.down_bytes,
            evals=[],
            metrics=metrics,
        )
        rec = self.recorder
        if rec.enabled:
            for name, n in self.counters.items():
                # shard coordinators share one recorder and see the same
                # events: only shard 0 flushes the run-level and per-client
                # counters, each shard its own shard/{i}/* rows
                if self.shard_id == 0 or name.startswith("shard/"):
                    rec.count(name, n)
            if self.shard_id == 0:
                async_sim._record_run_summary(
                    rec, "cluster", hist, None, None,
                    np.asarray(self._up_sizes, np.int64),
                    np.asarray(self._down_sizes, np.int64))
        return final, hist
