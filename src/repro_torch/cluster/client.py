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

One transport per client: the sharded coordinators (a transport per shard)
are a later slice of the port.
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
    device of ``params0``.
    """

    transport: Any
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

    def __post_init__(self):
        if self.recorder is None:
            self.recorder = telemetry.NULL
        if isinstance(self.transport, (list, tuple)):
            raise NotImplementedError(
                "a client of sharded coordinators (one transport per shard) "
                "is a later slice of the port (ROADMAP queue 1 item 3)")
        # retransmits this client issued after a reply timed out -- the
        # observable half of the fault injector's drop accounting
        self.retries = 0

    def run(self):
        """HELLO -> (UP/DOWN | SKIP)* -> BYE; returns (final local params,
        losses)."""
        rec = self.recorder
        addr = self.plan.client_id
        cat = f"client/{addr}"
        tp = self.transport
        device = tree_leaves(self.params0)[0].device
        space = ParamSpace.from_tree(self.params0)
        client_step = async_sim.make_client_step(self.strategy, self.grad_fn,
                                                 space)
        apply_G = async_sim.make_apply()
        up_mode = self.strategy.quantize
        up_seg = self.strategy.message_seg(space)

        hello, _ = wire.encode_message(wire.HELLO, addr,
                                       self._proposed_slot())
        tp.send(wire.COORDINATOR_ID, hello)
        _, reply = tp.recv(timeout=self.recv_timeout)
        welcome = wire.decode_message(reply, device=device)
        if welcome.type != wire.WELCOME:
            raise ConnectionError(f"client {addr}: expected WELCOME, got "
                                  f"{wire.TYPE_NAMES.get(welcome.type)}")
        slot = welcome.seq

        theta = space.pack(self.params0)   # the local model, as one arena
        strat = self.strategy.init(self.params0)
        losses, seq = [], 0
        for step in range(self.plan.n_rounds):
            if not participates(self.plan, step):
                skip, _ = wire.encode_message(wire.SKIP, addr, seq)
                tp.send(wire.COORDINATOR_ID, skip)
                continue
            e = step if self.event_fn is None else int(self.event_fn(step))
            lr = self.lr if self.lr_fn is None else float(self.lr_fn(e))
            batch = self.batch_fn(e, slot)
            with rec.span("client/step", cat=cat):
                strat, loss, msg = client_step(theta, strat, batch, lr)
                loss = float(loss)
            with rec.span("client/encode", cat=cat):
                payload, _ = wire.encode_message(
                    wire.UP, addr, seq, [msg], mode=up_mode, seg=up_seg,
                    aux=loss)
            with rec.span("client/exchange", cat=cat):
                tp.send(wire.COORDINATOR_ID, payload)
                down = self._await_down(payload, seq, device)
            with rec.span("client/apply", cat=cat):
                theta = apply_G(theta, down.leaves[0])
            losses.append(loss)
            seq += 1
        bye, _ = wire.encode_message(wire.BYE, addr, seq)
        tp.send(wire.COORDINATOR_ID, bye)
        return space.unpack(theta), losses

    def _proposed_slot(self) -> int:
        # schedule-driven runs pin client addr == worker slot; elastic
        # scenarios let the coordinator pick (AUTO_SLOT)
        if self.event_fn is not None:
            return self.plan.client_id
        return AUTO_SLOT

    def _await_down(self, payload: bytes, seq: int, device) -> wire.Message:
        """Wait for the DOWN to ``seq``, retransmitting the UP after each
        ``reply_timeout`` (at-least-once, deduplicated by the coordinator
        on ``seq``)."""
        timeout = self.reply_timeout or self.recv_timeout
        for _ in range(self.max_retries):
            try:
                _, reply = self.transport.recv(timeout=timeout)
            except RecvTimeout:
                if self.reply_timeout is None:
                    raise
                self.retries += 1
                self.recorder.count(
                    f"client/{self.plan.client_id}/retries")
                self.transport.send(wire.COORDINATOR_ID, payload)
                continue
            down = wire.decode_message(reply, device=device)
            if down.type == wire.DOWN and down.seq == seq:
                return down
            # stale duplicate reply from an earlier retransmit -- ignore
        raise RecvTimeout(f"client {self.plan.client_id}: no reply to "
                          f"seq {seq} after {self.max_retries} retries")
