"""Transports for the federated cluster runtime (PyTorch port of
``repro.cluster.transport``; pure Python and numpy, the reference's code
in the port's own copy).

A transport moves opaque byte payloads (wire.py messages) between numbered
endpoints.  Two backends share one interface:

* :class:`InProcHub` — thread-safe queues inside one process.  Fully
  deterministic when the coordinator drives receives with ``recv(src=...)``
  (selective receive): arrival *order* across clients never influences the
  served order, so a schedule-driven coordinator reproduces the simulator's
  event sequence exactly no matter how client threads interleave.
* :class:`TcpCoordinatorTransport` / :class:`TcpClientTransport` — real
  length-prefixed frames over TCP sockets, one process per peer.

Event *schedulers* decide which client the coordinator serves next:

* :class:`ScheduleDriven` — an explicit worker-slot order (e.g. from
  ``async_sim.make_schedule``); the bit-parity mode.
* :class:`VirtualClock` — per-client virtual completion times advanced by
  compute time + measured message bytes / bandwidth + fault delay; the
  generalization of ``make_schedule`` that knows about bandwidth caps,
  joins, and leaves.

Fault injection (:class:`FaultPolicy` + :class:`FaultInjector`) applies
per-client bandwidth caps, extra latency, and seeded frame drops at the
transport boundary.  Dropped frames are survived by the client's
send-with-retry loop and the coordinator's duplicate-``seq`` cache
(coordinator.py) — classic at-least-once delivery.
"""
from __future__ import annotations

import dataclasses
import queue
import socket
import struct
import threading
import time
from typing import Protocol, runtime_checkable

import numpy as np

_FRAME_LEN = struct.Struct("<I")
_ANNOUNCE = struct.Struct("<I")


class TransportClosed(ConnectionError):
    pass


class RecvTimeout(TimeoutError):
    pass


@runtime_checkable
class Transport(Protocol):
    """Point-to-point byte transport between numbered endpoints."""

    def send(self, dst: int, payload: bytes) -> None: ...

    def recv(self, src: int | None = None, *,
             timeout: float | None = None) -> tuple[int, bytes]: ...

    def close(self) -> None: ...


# ---------------------------------------------------------------------------
# shared inbox with selective receive
# ---------------------------------------------------------------------------

class _Inbox:
    """One merged queue + per-source stash so ``recv(src=k)`` is possible
    regardless of the order other peers' messages arrive in."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._stash: dict[int, list[bytes]] = {}

    def put(self, src: int, payload: bytes):
        self._q.put((src, payload))

    def get(self, src: int | None, timeout: float | None):
        if src is None:
            for s, items in self._stash.items():
                if items:
                    return s, items.pop(0)
            try:
                return self._q.get(timeout=timeout)
            except queue.Empty:
                raise RecvTimeout("no message")
        items = self._stash.get(src)
        if items:
            return src, items.pop(0)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            try:
                s, payload = self._q.get(timeout=remaining)
            except queue.Empty:
                raise RecvTimeout(f"no message from {src}")
            if s == src:
                return s, payload
            self._stash.setdefault(s, []).append(payload)

    def poll(self, accept):
        """Non-blocking selective drain: the next message whose *source*
        satisfies ``accept(src)``, or None.

        Messages from non-accepted sources are stashed — exactly what a
        selective :meth:`get` would do with them — so polling for (e.g.)
        subscriber-range traffic never reorders or consumes the frames a
        schedule-driven receive loop is waiting on.
        """
        for s, items in self._stash.items():
            if items and accept(s):
                return s, items.pop(0)
        while True:
            try:
                s, payload = self._q.get_nowait()
            except queue.Empty:
                return None
            if accept(s):
                return s, payload
            self._stash.setdefault(s, []).append(payload)


# ---------------------------------------------------------------------------
# in-process backend
# ---------------------------------------------------------------------------

class InProcHub:
    """Registry of in-process endpoints addressed by integer id."""

    def __init__(self):
        self._inboxes: dict[int, _Inbox] = {}
        self._lock = threading.Lock()

    def endpoint(self, addr: int) -> "InProcEndpoint":
        with self._lock:
            if addr in self._inboxes:
                raise ValueError(f"address {addr} already registered")
            self._inboxes[addr] = _Inbox()
        return InProcEndpoint(self, addr)

    def _deliver(self, src: int, dst: int, payload: bytes):
        try:
            inbox = self._inboxes[dst]
        except KeyError:
            raise TransportClosed(f"no endpoint {dst}")
        inbox.put(src, payload)


@dataclasses.dataclass
class InProcEndpoint:
    hub: InProcHub
    addr: int

    def send(self, dst: int, payload: bytes) -> None:
        self.hub._deliver(self.addr, dst, payload)

    def recv(self, src: int | None = None, *,
             timeout: float | None = None) -> tuple[int, bytes]:
        return self.hub._inboxes[self.addr].get(src, timeout)

    def poll(self, accept):
        return self.hub._inboxes[self.addr].poll(accept)

    def close(self) -> None:
        pass


class ShardEndpointView:
    """One client endpoint seen through a single coordinator SHARD.

    The S-thread sharded parameter server runs ``S`` coordinator shards on
    distinct addresses; a client keeps ONE inbox but speaks to every shard.
    This view pins sends addressed to the logical coordinator onto shard
    ``shard_addr`` and receives selectively from it (the shared inbox
    stashes other shards' replies), so the client's per-shard exchange
    reuses the unsharded protocol verbatim.
    """

    def __init__(self, endpoint, shard_addr: int):
        self.endpoint = endpoint
        self.shard_addr = shard_addr

    def send(self, dst: int, payload: bytes) -> None:
        self.endpoint.send(self.shard_addr, payload)

    def recv(self, src: int | None = None, *,
             timeout: float | None = None) -> tuple[int, bytes]:
        return self.endpoint.recv(self.shard_addr, timeout=timeout)

    def close(self) -> None:
        pass   # the shared endpoint outlives its shard views


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Per-client link model: cap, latency, loss.

    bandwidth: bytes/second (None = infinite); delay: extra seconds per
    frame; drop_prob: probability a frame is silently lost; seed makes the
    drop sequence reproducible.  ``realtime=False`` (in-process virtual-time
    runs) books the cost with the scheduler instead of sleeping.
    """

    bandwidth: float | None = None
    delay: float = 0.0
    drop_prob: float = 0.0
    seed: int = 0
    realtime: bool = True

    def frame_cost(self, nbytes: int) -> float:
        cost = self.delay
        if self.bandwidth:
            cost += nbytes / self.bandwidth
        return cost


class FaultInjector:
    """Wrap an endpoint with a FaultPolicy (applies to sends only).

    ``droppable(payload) -> bool`` restricts loss to frames the sender will
    retransmit (the runtime passes UP frames only — losing a fire-and-forget
    SKIP/BYE would strand the coordinator waiting on a turn that never
    comes); bandwidth/delay costs still apply to every frame.
    """

    def __init__(self, inner, policy: FaultPolicy, droppable=None):
        self.inner = inner
        self.policy = policy
        self.droppable = droppable or (lambda payload: True)
        self._rng = np.random.default_rng(policy.seed)
        self.dropped = 0

    def send(self, dst: int, payload: bytes) -> None:
        if self.policy.realtime:
            cost = self.policy.frame_cost(len(payload))
            if cost:
                time.sleep(cost)
        # realtime=False: byte costs are booked by the coordinator against
        # its VirtualClock (Coordinator._account), not here
        if self.policy.drop_prob and self.droppable(payload) and \
                self._rng.random() < self.policy.drop_prob:
            self.dropped += 1
            return
        self.inner.send(dst, payload)

    def recv(self, src: int | None = None, *, timeout: float | None = None):
        return self.inner.recv(src, timeout=timeout)

    def close(self) -> None:
        self.inner.close()


# ---------------------------------------------------------------------------
# event schedulers
# ---------------------------------------------------------------------------

class ScheduleDriven:
    """Serve clients in an explicit slot order (bit-parity with the
    simulator's ``make_schedule``)."""

    def __init__(self, order):
        self.order = [int(x) for x in order]
        self._i = 0

    def register(self, client: int, t_join: float = 0.0):
        pass

    def next_client(self) -> int | None:
        if self._i >= len(self.order):
            return None
        k = self.order[self._i]
        self._i += 1
        return k

    def next_batch(self, max_batch: int | None = None) -> list[int]:
        """The next maximal run of PAIRWISE-DISTINCT clients, truncated to
        a power of two — ``async_sim.batch_schedule``'s rule, so a batched
        coordinator serves the exact event order the simulator batches.
        Advances the cursor by the kept length; empty when exhausted."""
        n = len(self.order)
        if self._i >= n:
            return []
        limit = n if max_batch is None else min(n, self._i + int(max_batch))
        seen: set[int] = set()
        j = self._i
        while j < limit and self.order[j] not in seen:
            seen.add(self.order[j])
            j += 1
        size = 1 << ((j - self._i).bit_length() - 1)
        batch = self.order[self._i:self._i + size]
        self._i += size
        return batch

    def account(self, client: int, cost: float):
        pass

    def deactivate(self, client: int):
        pass


class VirtualClock:
    """Argmin-of-completion-times scheduler (bandwidth/fault aware).

    The continuous-time generalization of ``async_sim.make_schedule``:
    each client k has a virtual clock t_k; the next served client is the
    active one with the smallest t_k, and serving advances t_k by its
    compute time plus whatever byte/fault costs the coordinator books via
    :meth:`account`.
    """

    def __init__(self, compute_time=None):
        self._t: dict[int, float] = {}
        self._dt: dict[int, float] = {}
        self._active: set[int] = set()
        self._compute_time = compute_time or {}

    def register(self, client: int, t_join: float = 0.0,
                 compute_time: float = 1.0):
        self._t[client] = t_join
        self._dt[client] = self._compute_time.get(client, compute_time)
        self._active.add(client)

    def next_client(self) -> int | None:
        if not self._active:
            return None
        return min(self._active, key=lambda k: (self._t[k], k))

    def account(self, client: int, cost: float = 0.0):
        self._t[client] += self._dt[client] + cost

    def deactivate(self, client: int):
        self._active.discard(client)

    @property
    def now(self) -> float:
        return min((self._t[k] for k in self._active), default=0.0)


# ---------------------------------------------------------------------------
# TCP backend
# ---------------------------------------------------------------------------

def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise TransportClosed("peer closed")
        buf += chunk
    return buf


def _write_frame(sock: socket.socket, payload: bytes):
    sock.sendall(_FRAME_LEN.pack(len(payload)) + payload)


def _read_frame(sock: socket.socket) -> bytes:
    (n,) = _FRAME_LEN.unpack(_read_exact(sock, _FRAME_LEN.size))
    return _read_exact(sock, n)


class TcpCoordinatorTransport:
    """Listening side: accepts clients, one reader thread per connection.

    Each client announces its integer address right after connecting; all
    subsequent frames land in the shared inbox tagged with it.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._listener = socket.create_server((host, port))
        self.host, self.port = self._listener.getsockname()[:2]
        self._inbox = _Inbox()
        self._conns: dict[int, socket.socket] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    def _reader(self, conn: socket.socket):
        try:
            (addr,) = _ANNOUNCE.unpack(_read_exact(conn, _ANNOUNCE.size))
            with self._lock:
                self._conns[addr] = conn
            while True:
                self._inbox.put(addr, _read_frame(conn))
        except (TransportClosed, OSError):
            conn.close()

    def send(self, dst: int, payload: bytes) -> None:
        with self._lock:
            conn = self._conns.get(dst)
        if conn is None:
            raise TransportClosed(f"client {dst} not connected")
        _write_frame(conn, payload)

    def recv(self, src: int | None = None, *,
             timeout: float | None = None) -> tuple[int, bytes]:
        return self._inbox.get(src, timeout)

    def poll(self, accept):
        return self._inbox.poll(accept)

    def close(self) -> None:
        self._closed = True
        self._listener.close()
        with self._lock:
            for conn in self._conns.values():
                conn.close()
            self._conns.clear()


class TcpClientTransport:
    """Connecting side: one socket to the coordinator.

    Receives through a persistent buffer so a ``recv`` timeout that fires
    mid-frame never loses the partial bytes — the retry loop's next call
    resumes the same frame instead of desyncing the stream.
    """

    def __init__(self, host: str, port: int, addr: int,
                 connect_timeout: float = 30.0):
        from repro_torch.cluster import wire

        self.addr = addr
        self._coord = wire.COORDINATOR_ID
        self._buf = b""
        deadline = time.monotonic() + connect_timeout
        while True:
            try:
                self._sock = socket.create_connection(
                    (host, port), timeout=connect_timeout)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)   # coordinator may still be binding
        self._sock.sendall(_ANNOUNCE.pack(addr))

    def send(self, dst: int, payload: bytes) -> None:
        _write_frame(self._sock, payload)

    def recv(self, src: int | None = None, *,
             timeout: float | None = None) -> tuple[int, bytes]:
        self._sock.settimeout(timeout)
        try:
            while True:
                if len(self._buf) >= _FRAME_LEN.size:
                    (n,) = _FRAME_LEN.unpack_from(self._buf, 0)
                    end = _FRAME_LEN.size + n
                    if len(self._buf) >= end:
                        payload = self._buf[_FRAME_LEN.size:end]
                        self._buf = self._buf[end:]
                        return self._coord, payload
                chunk = self._sock.recv(1 << 16)
                if not chunk:
                    raise TransportClosed("coordinator closed")
                self._buf += chunk
        except socket.timeout:
            raise RecvTimeout("coordinator silent")

    def close(self) -> None:
        self._sock.close()
