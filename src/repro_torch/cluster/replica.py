"""The inference replica: decode against a live, sparsely updated model
(PyTorch port of ``repro.cluster.replica``).

A replica SUBscribes to the training coordinator and interleaves decode
work with DIFF pulls:

    SUB  -> DIFF(residual)          initial catch-up: all of M so far
    PULL -> DIFF(residual)          one coalesced re-sparsified push
    ...                             decode, decode, ...
    SYNC -> DIFF(M, dense)          bit-exact final handshake

Pulls are *pipelined* against decode: the replica fires a PULL, keeps
decoding, and applies the reply at the next decode boundary it finds it
at.  The staleness bound caps the pipeline: after ``max_staleness`` decode
boundaries with the PULL still unanswered, the replica blocks until the
diff lands (bounded-staleness serving, the replica's mirror of the
coordinator's per-push version-lag counters).

A diff applies as Eq. 5, ``theta <- theta + G``, in place through the flat
scatter-add (kernel row 1), as the training client applies; the final
model is ``theta_0 + M``, one dense elementwise add, bit-equal to
``server.global_model``.  ``theta_0`` and ``theta`` stay on the device of
``params0``; only the frames cross from the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import telemetry
from repro_torch.core import server as ps
from repro_torch.core.paramspace import ParamSpace, tree_leaves
from repro_torch.core.sparsify import SparseLeaf

from . import wire
from .transport import RecvTimeout

# TcpClientTransport maps ``settimeout(0)`` to non-blocking mode (raising
# BlockingIOError, not socket.timeout): poll with a small epsilon instead
POLL_EPS = 0.01


@dataclasses.dataclass
class ReplicaResult:
    arena: torch.Tensor   # final (total,) f32 on the device: theta_0 + M
    params: Any           # the same, unpacked to the parameter tree
    version: int          # server version at SYNC
    stats: dict


class InferenceReplica:
    """One subscriber endpoint: pull sparse diffs, decode, SYNC out.
    Computes on the device of ``params0``."""

    def __init__(self, transport, params0, *, replica_id: int = 0,
                 max_staleness: int = 4,
                 decode_fn: Callable | None = None,
                 recorder=None, recv_timeout: float | None = None):
        self.transport = transport
        self.replica_id = int(replica_id)
        self.addr = wire.SUBSCRIBER_BASE + self.replica_id
        self.max_staleness = max(1, int(max_staleness))
        self.decode_fn = decode_fn
        self.recorder = telemetry.NULL if recorder is None else recorder
        self.recv_timeout = recv_timeout
        self.space = ParamSpace.from_tree(params0)
        self.device = tree_leaves(params0)[0].device
        # theta_0's arena: the SYNC handshake recomputes theta_0 + M from
        # it, and theta starts as a fresh copy (apply writes theta in place)
        self._theta0 = self.space.pack(params0)
        self.stats = {"pulls": 0, "diffs": 0, "decodes": 0, "bytes_in": 0,
                      "applied_entries": 0, "stale_waits": 0,
                      "version_jump_max": 0}
        self.version = -1

    # -- protocol ----------------------------------------------------------

    def _send(self, msg_type: int, seq: int):
        payload, _ = wire.encode_message(msg_type, self.addr, seq)
        self.transport.send(wire.COORDINATOR_ID, payload)

    def _recv_diff(self, timeout):
        _, payload = self.transport.recv(None, timeout=timeout)
        msg = wire.decode_message(payload, device=self.device)
        if msg.type != wire.DIFF:
            raise ValueError(f"replica expected DIFF, got "
                             f"{wire.TYPE_NAMES.get(msg.type, msg.type)}")
        self.stats["bytes_in"] += len(payload)
        return msg

    def _apply(self, theta, msg):
        leaf = msg.leaves[0]
        with self.recorder.span("replica/apply", replica=self.replica_id,
                                version=msg.seq):
            theta = ps.apply_update(theta, leaf)
        self.stats["diffs"] += 1
        self.stats["applied_entries"] += int(getattr(leaf, "k", 0))
        if self.version >= 0:
            self.stats["version_jump_max"] = max(
                self.stats["version_jump_max"], int(msg.seq) - self.version)
        self.version = int(msg.seq)
        return theta, float(msg.aux) >= 1.0

    def run(self, max_decodes: int | None = None) -> ReplicaResult:
        """Decode until training quiesces (or ``max_decodes``), then SYNC.

        Returns the bit-exact final model.  ``decode_fn(params, step)`` is
        called at every decode boundary with the replica's CURRENT
        (bounded-staleness) parameters: views of the live arena, valid for
        the call (the next diff writes them in place), so it must compute
        from the params it is given and keep nothing of them.
        """
        rec = self.recorder
        theta = self._theta0.clone()
        self._send(wire.SUB, 0)
        theta, quiesced = self._apply(
            theta, self._recv_diff(self.recv_timeout))

        pending = False   # one PULL in flight at a time
        stale = 0
        step = 0
        while not quiesced and (max_decodes is None or step < max_decodes):
            if not pending:
                self._send(wire.PULL, step)
                self.stats["pulls"] += 1
                pending, stale = True, 0
            else:
                try:
                    block = stale >= self.max_staleness
                    if block:
                        self.stats["stale_waits"] += 1
                    msg = self._recv_diff(
                        self.recv_timeout if block else POLL_EPS)
                    theta, quiesced = self._apply(theta, msg)
                    pending = False
                except RecvTimeout:
                    stale += 1
            if self.decode_fn is not None:
                with rec.span("replica/decode", replica=self.replica_id,
                              step=step):
                    self.decode_fn(self.space.unpack(theta), step)
            self.stats["decodes"] += 1
            step += 1

        if pending:   # absorb the outstanding reply before the handshake
            theta, quiesced = self._apply(
                theta, self._recv_diff(self.recv_timeout))

        # SYNC: the coordinator answers with ALL of M, dense; theta_0 + M
        # is the same elementwise f32 add as server.global_model, so the
        # served model matches the trainer's final bits exactly
        self._send(wire.SYNC, step)
        msg = self._recv_diff(self.recv_timeout)
        if isinstance(msg.leaves[0], SparseLeaf):
            raise ValueError("SYNC reply must be a dense arena frame")
        with rec.span("replica/sync", replica=self.replica_id,
                      version=msg.seq):
            arena = self._theta0 + msg.leaves[0]
        self.version = int(msg.seq)
        self.stats["version"] = self.version
        if rec.enabled:
            for k, v in self.stats.items():
                rec.count(f"replica/{self.replica_id}/{k}", v)
        return ReplicaResult(arena=arena, params=self.space.unpack(arena),
                             version=self.version, stats=dict(self.stats))
