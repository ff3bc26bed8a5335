"""The federated client: local compute on a stale model, sparse exchange
(PyTorch port of ``repro.cluster.client``).

Runs the SAME stages as the simulator (``async_sim.make_client_step`` /
``make_apply``); the upward message leaves the step raw and the wire codec
quantizes it during encode, exactly as ``AsyncTrainer`` does in-process
with ``wire.quantize_message``.  The client applies the DECODED downward
message, which is bit for bit what the coordinator committed.

Scenario behaviour lives here too: per-round participation (SKIP frames),
bounded life (BYE after ``plan.n_rounds``), and at-least-once retry -- a
frame lost to fault injection is retransmitted after ``reply_timeout`` and
deduplicated by the coordinator on ``seq``.  Every wait is bounded: without
retransmits a reply that does not come within ``recv_timeout`` raises.

Against the S-thread sharded parameter server ``transport`` is a list of
per-shard transports (shard order) and ``shard_spec`` the range partition:
each upward message splits by index range and fans out as one shard-local
frame per coordinator shard before the client waits on any reply, and the
per-shard downward diffs merge (indices rebased back by ``bounds[s]``) into
one global message before the single arena apply -- bit-equal to the
unsharded exchange.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch import telemetry
from repro_torch.core import async_sim
from repro_torch.core.baselines import Strategy
from repro_torch.core.paramspace import ParamSpace, tree_leaves

from . import wire
from .scenarios import ClientPlan, participates
from .transport import RecvTimeout

AUTO_SLOT = 0xFFFFFFFF


@dataclasses.dataclass
class ClusterClient:
    """One worker thread or process speaking the cluster wire protocol.

    ``batch_fn(event_idx, slot) -> batch``; ``event_fn(local_step) -> int``
    maps local steps to the event index fed to batch_fn/lr_fn -- in
    schedule-driven (parity) runs this is the client's slice of the global
    schedule, otherwise the local step count.  The client computes on the
    device of ``params0``.  With several transports (one per shard) every
    shard must seat the client in the same slot, so the client proposes
    its own id as ``pin_slot`` does, and shard 0's WELCOME decides.
    """

    transport: Any                       # one transport, or one per shard
    strategy: Strategy
    grad_fn: Callable
    params0: Any
    batch_fn: Callable
    plan: ClientPlan
    lr: float = 0.1
    lr_fn: Callable | None = None
    event_fn: Callable | None = None
    reply_timeout: float | None = None   # retransmit interval under drops
    max_retries: int = 50
    recorder: Any = None                 # telemetry.Recorder (None = no-op)
    recv_timeout: float = 300.0          # longest wait with no retransmit
    shard_spec: Any = None               # ShardSpec; required with S > 1
    pin_slot: bool = False               # propose slot == client_id on HELLO

    def __post_init__(self):
        if self.recorder is None:
            self.recorder = telemetry.NULL
        self._transports = (list(self.transport)
                            if isinstance(self.transport, (list, tuple))
                            else [self.transport])
        if len(self._transports) > 1 and self.shard_spec is None:
            raise ValueError("a sharded client (multiple transports) "
                             "needs shard_spec=")
        if self.shard_spec is not None \
                and len(self._transports) != self.shard_spec.n_shards:
            raise ValueError(
                f"{len(self._transports)} transports for "
                f"{self.shard_spec.n_shards} shards")
        # retransmits this client issued after a reply timed out -- the
        # observable half of the fault injector's drop accounting
        self.retries = 0

    def run(self):
        """HELLO -> (UP/DOWN | SKIP)* -> BYE; returns (final local params,
        losses)."""
        rec = self.recorder
        addr = self.plan.client_id
        cat = f"client/{addr}"
        device = tree_leaves(self.params0)[0].device
        space = ParamSpace.from_tree(self.params0)
        client_step = async_sim.make_client_step(self.strategy, self.grad_fn,
                                                 space)
        apply_G = async_sim.make_apply()
        up_mode = self.strategy.quantize
        up_seg = self.strategy.message_seg(space)

        hello, _ = wire.encode_message(wire.HELLO, addr,
                                       self._proposed_slot())
        slot = None
        for tp in self._transports:
            tp.send(wire.COORDINATOR_ID, hello)
            _, reply = tp.recv(timeout=self.recv_timeout)
            welcome = wire.decode_message(reply, device=device)
            if welcome.type != wire.WELCOME:
                raise ConnectionError(f"client {addr}: expected WELCOME, got "
                                      f"{wire.TYPE_NAMES.get(welcome.type)}")
            if slot is None:     # shard 0 decides
                slot = welcome.seq

        theta = space.pack(self.params0)   # the local model, as one arena
        strat = self.strategy.init(self.params0)
        losses, seq = [], 0
        for step in range(self.plan.n_rounds):
            if not participates(self.plan, step):
                skip, _ = wire.encode_message(wire.SKIP, addr, seq)
                for tp in self._transports:
                    tp.send(wire.COORDINATOR_ID, skip)
                continue
            e = step if self.event_fn is None else int(self.event_fn(step))
            lr = self.lr if self.lr_fn is None else float(self.lr_fn(e))
            batch = self.batch_fn(e, slot)
            with rec.span("client/step", cat=cat):
                strat, loss, msg = client_step(theta, strat, batch, lr)
                loss = float(loss)
            with rec.span("client/encode", cat=cat):
                if self.shard_spec is not None:
                    payloads = [p for p, _ in wire.encode_sharded_message(
                        wire.UP, addr, seq, msg, shard_spec=self.shard_spec,
                        mode=up_mode, seg=up_seg, aux=loss)]
                else:
                    payloads = [wire.encode_message(
                        wire.UP, addr, seq, [msg], mode=up_mode, seg=up_seg,
                        aux=loss)[0]]
            with rec.span("client/exchange", cat=cat):
                # fan out every shard's UP before waiting on any DOWN: the
                # shards serve concurrently, the client pays one round trip
                for tp, p in zip(self._transports, payloads):
                    tp.send(wire.COORDINATOR_ID, p)
                downs = [self._await_down(tp, p, seq, device)
                         for tp, p in zip(self._transports, payloads)]
            with rec.span("client/apply", cat=cat):
                if self.shard_spec is not None:
                    G = self.shard_spec.merge([d.leaves[0] for d in downs])
                else:
                    G = downs[0].leaves[0]
                theta = apply_G(theta, G)
            losses.append(loss)
            seq += 1
        bye, _ = wire.encode_message(wire.BYE, addr, seq)
        for tp in self._transports:
            tp.send(wire.COORDINATOR_ID, bye)
        return space.unpack(theta), losses

    def _proposed_slot(self) -> int:
        # schedule-driven runs pin client addr == worker slot, and so do
        # sharded runs, where every shard must agree on the slot; elastic
        # scenarios let the coordinator pick (AUTO_SLOT)
        if self.event_fn is not None or self.pin_slot \
                or len(self._transports) > 1:
            return self.plan.client_id
        return AUTO_SLOT

    def _await_down(self, transport, payload: bytes, seq: int,
                    device) -> wire.Message:
        """Wait for one shard's DOWN to ``seq``, retransmitting the UP after
        each ``reply_timeout`` (at-least-once, deduplicated by the
        coordinator on ``seq``).  The fan-out in :meth:`run` sent it."""
        timeout = self.reply_timeout or self.recv_timeout
        for _ in range(self.max_retries):
            try:
                _, reply = transport.recv(timeout=timeout)
            except RecvTimeout:
                if self.reply_timeout is None:
                    raise
                self.retries += 1
                self.recorder.count(
                    f"client/{self.plan.client_id}/retries")
                transport.send(wire.COORDINATOR_ID, payload)
                continue
            down = wire.decode_message(reply, device=device)
            if down.type == wire.DOWN and down.seq == seq:
                return down
            # stale duplicate reply from an earlier retransmit -- ignore
        raise RecvTimeout(f"client {self.plan.client_id}: no reply to "
                          f"seq {seq} after {self.max_retries} retries")
