"""Subscriber-side state of the serve leg: residual arenas and DIFF framing
(PyTorch port of ``repro.cluster.subscribe``).

An inference replica is a *read-only worker*: the coordinator keeps a
cursor arena ``v_sub`` per subscriber -- the per-worker ``v_k`` row of the
parameter server (Eq. 3/4) -- and every push ships the re-sparsified
residual

    r = M - v_sub

as ONE ARENA frame, quantized in flight (one launch of the segmented
quantize on the card).  Committing the *shipped* leaf back into ``v_sub``
(the flat scatter-add, kernel row 1) makes the residual self-correcting:
whatever the top-k selection or the wire quantization dropped from this
push stays in ``M - v_sub`` and rides the next one, so a slow replica gets
one catch-up diff, never a replay.

The final handshake is bit-exact by construction: SYNC answers with ALL of
``M`` as a dense frame, and the replica computes ``theta_0 + M``, the same
elementwise f32 add as ``server.global_model``.

The cursors live on the coordinator's device; only the frames cross to the
host.  This module owns the per-subscriber state and the framing; the
coordinator drives transport, counters and spans.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import engine as engine_lib
from repro_torch.core.engine import CompressionSpec
from repro_torch.core.sparsify import SparseLeaf
from repro_torch.device import resolve_device

from . import wire


@dataclasses.dataclass
class Subscriber:
    """One replica's cursor state on the coordinator."""

    addr: int
    v: torch.Tensor      # (total,) f32 cursor arena: what it has seen
    version: int = 0     # server version its last DIFF brought it to
    pushes: int = 0
    push_bytes: int = 0
    lag_max: int = 0
    synced: bool = False


class SubscriberBook:
    """Cursor arenas and DIFF/SYNC framing for every live subscriber, on
    ``device`` (None = the card)."""

    def __init__(self, space, *, push_density: float | None = None,
                 push_spec: CompressionSpec = engine_lib.EXACT_SPEC,
                 device=None):
        self.space = space
        self.device = resolve_device(device)
        self.push_density = push_density
        self.push_spec = push_spec
        self._select_spec = dataclasses.replace(push_spec, quantize="none")
        self._ks = (space.ks(push_density)
                    if push_density is not None else None)
        self.subs: dict[int, Subscriber] = {}
        self.seen: set[int] = set()

    def live(self) -> list[int]:
        return sorted(self.subs)

    def add(self, addr: int) -> Subscriber:
        """Register ``addr`` with a zero cursor: the residual is all of M,
        so its first DIFF is the full catch-up, as for a fresh worker
        slot."""
        sub = Subscriber(addr=addr, v=torch.zeros(
            self.space.total, dtype=torch.float32, device=self.device))
        self.subs[addr] = sub
        self.seen.add(addr)
        return sub

    def drop(self, addr: int):
        self.subs.pop(addr, None)

    # -- framing -----------------------------------------------------------

    def _residual_leaf(self, M: torch.Tensor, sub: Subscriber):
        """Re-sparsified residual of everything ``sub`` has not seen, and
        its segmentation.

        ``push_density`` set: the per-tensor top-|.| of ``M - v_sub``
        through the engine registry (the training path's own selection).
        ``None``: the exact nonzero residual; ``nonzero`` gives its indices
        ascending, and only their count crosses to the host.
        """
        r = M - sub.v
        if self._ks is not None:
            return self.space.select(r, self._ks, self._select_spec), self._ks
        idx = torch.nonzero(r).reshape(-1)
        k = int(idx.numel())
        leaf = SparseLeaf(values=r[idx], indices=idx.to(torch.int32),
                          size=self.space.total)
        return leaf, (k,) if k else ()

    def _account(self, sub: Subscriber, version: int, payload: bytes):
        sub.lag_max = max(sub.lag_max, version - sub.version)
        sub.version = version
        sub.pushes += 1
        sub.push_bytes += len(payload)

    def diff_payload(self, addr: int, M, version: int,
                     quiesced: bool) -> bytes:
        """One push: encode the residual DIFF and commit the shipped bits.

        ``seq`` carries the server version this diff brings the replica
        to; ``aux`` is 1.0 once training quiesced (the replica's cue to
        SYNC).  The SHIPPED leaf -- what the decoder reconstructs after
        wire quantization -- is scatter-added into ``v_sub``, so the
        cursor tracks exactly the bits the replica applied.
        """
        from repro_torch.kernels import ops

        sub = self.subs[addr]
        leaf, seg = self._residual_leaf(M, sub)
        payload, shipped = wire.encode_message(
            wire.DIFF, wire.COORDINATOR_ID, version & 0xFFFFFFFF, [leaf],
            mode=self.push_spec.quantize, seg=seg,
            aux=1.0 if quiesced else 0.0)
        ship = shipped[0]
        if ship.k:
            ops.scatter_add(sub.v, ship.indices, ship.values)
        self._account(sub, version, payload)
        return payload

    def sync_payload(self, addr: int, M, version: int) -> bytes:
        """The bit-exact final: the full accumulated update, dense.  The
        replica reconstructs ``theta_0 + M``, the same bits as
        ``server.global_model``, so no sparse push history can leave
        residue in the served model."""
        sub = self.subs[addr]
        payload, _ = wire.encode_message(
            wire.DIFF, wire.COORDINATOR_ID, version & 0xFFFFFFFF,
            [M.to(torch.float32)], aux=1.0)
        self._account(sub, version, payload)
        sub.synced = True
        return payload
