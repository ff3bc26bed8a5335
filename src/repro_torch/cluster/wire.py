"""Packed binary wire codec of the cluster runtime (PyTorch port of
``repro.cluster.wire``).

Every message between a client and the coordinator is one *envelope*
followed by zero or more length-prefixed *frames*:

    envelope:   u8  type      HELLO/WELCOME/UP/DOWN/SKIP/BYE, and the serve
                              leg's SUB/PULL/SYNC/DIFF
                u32 sender    client id (coordinator = 0xFFFFFFFF)
                u32 seq       per-sender sequence number (HELLO: the proposed
                              slot; WELCOME: the assigned worker slot)
                f32 aux       UP: the worker's scalar loss; else 0
                u32 n_leaves

    frame:      u32 frame_len (bytes after this field)
                u16 leaf_id   (ARENA frames reuse this field as n_seg)
                u8  mode      value packing: 0 none / 1 bf16 / 2 int8 / 3 tern
                u8  kind      0 sparse COO / 1 dense f32 / 2 dense-as-COO /
                              3 ARENA (global-index COO over the packed
                              parameter arena, segmented per tensor)
                u32 k         number of entries carried
                u32 size      dense length of the leaf / arena
                [f32 scale]   kind 0, int8/tern only: the per-message scale
                uN * k        indices (kinds 0, 2, 3); u8 when size <= 256,
                              u16 when size <= 65536, u32 beyond
                values        none: f32*k | bf16: u16*k | int8: i8*k
                              tern: 2-bit codes, 4 per byte
                              dense f32 (kind 1): f32*size, no indices

    ARENA body (kind 3), between the header and the index block:
                u32 * n_seg   per-tensor entry counts (the segmentation)
                f32 * n_seg   int8/tern only: one scale PER TENSOR

All integers little-endian; the layout is the reference's byte for byte, so
either package decodes the other's frames.  Dense leaves always travel f32
(kind 1 or 2, whichever is smaller for the actual nnz).

An ARENA encode (:func:`pack_from_arena`) quantizes and packs the values on
the message's device with one launch of the segmented quantize
(``kernels/wire_pack.frame_tail``), which writes the frame's scales,
narrowed indices and codes into one buffer; that buffer crosses to the host
in one copy.  Its ``shipped`` values are
bit for bit what :func:`decode_message` reconstructs on the far side, and
what the simulator's :func:`quantize_message` stands in for, so a
schedule-driven cluster run reproduces ``AsyncTrainer.run``.  The decoder
reads bf16 exactly, as ``u16 << 16`` viewed as f32, and hands the leaves to
their device through pinned memory (``device.from_host``).
"""
from __future__ import annotations

import struct
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.sparsify import (SparseLeaf, quantize_parts,
                                       quantize_segments)
from repro_torch.device import from_host, resolve_device

# message types; SUB/PULL/SYNC/DIFF are the serve leg's (replicas)
HELLO, WELCOME, UP, DOWN, SKIP, BYE = range(6)
SUB, PULL, SYNC, DIFF = 6, 7, 8, 9
TYPE_NAMES = {HELLO: "HELLO", WELCOME: "WELCOME", UP: "UP", DOWN: "DOWN",
              SKIP: "SKIP", BYE: "BYE", SUB: "SUB", PULL: "PULL",
              SYNC: "SYNC", DIFF: "DIFF"}
COORDINATOR_ID = 0xFFFFFFFF

# inference replicas address themselves from a reserved id range, clear of
# client ids (small ints) and of shard coordinators (just under
# COORDINATOR_ID)
SUBSCRIBER_BASE = 1 << 30


def is_subscriber(addr: int) -> bool:
    """True when ``addr`` is in the reserved inference-replica id range."""
    return SUBSCRIBER_BASE <= addr < COORDINATOR_ID - (1 << 16)


# value packing modes (wire codes)
MODES = {"none": 0, "bf16": 1, "int8": 2, "tern": 3}
MODE_NAMES = {v: k for k, v in MODES.items()}

# leaf kinds
SPARSE, DENSE, DENSE_COO, ARENA = 0, 1, 2, 3

_ENVELOPE = struct.Struct("<BIIfI")     # 17 bytes
_LEN = struct.Struct("<I")              # 4-byte frame length prefix
_HEADER = struct.Struct("<HBBII")       # 12-byte frame header
_SCALE = struct.Struct("<f")

ENVELOPE_BYTES = _ENVELOPE.size


class Message(NamedTuple):
    type: int
    sender: int
    seq: int
    aux: float
    leaves: list  # [SparseLeaf | flat f32 tensor], leaf_id order


def quantize_message(msg, mode: str, seg=None):
    """Apply wire quantization to a message -- what the decoder on the far
    side reconstructs.  Sparse arena messages quantize per segment (one
    scale per tensor; ``seg`` defaults to one segment); a stacked batch of
    them, ``(B, k)`` values, quantizes each row with its own scales; dense
    messages travel f32 and pass through."""
    if mode == "none" or not isinstance(msg, SparseLeaf):
        return msg
    if seg is None:
        seg = (msg.k,)
    return SparseLeaf(values=quantize_segments(msg.values, mode, seg),
                      indices=msg.indices, size=msg.size)


# ---------------------------------------------------------------------------
# size accounting -- matches serialization by construction
# ---------------------------------------------------------------------------

def _value_nbytes(k: int, mode: str) -> int:
    return {"none": 4 * k, "bf16": 2 * k, "int8": k,
            "tern": (k + 3) // 4}[mode]


def index_dtype(size: int):
    """Narrowest unsigned index type for a ``size``-element leaf."""
    if size <= 1 << 8:
        return np.uint8
    if size <= 1 << 16:
        return np.uint16
    return np.uint32


def _index_nbytes(size: int) -> int:
    return np.dtype(index_dtype(size)).itemsize


def leaf_frame_bytes(k: int, size: int, mode: str, kind: int = SPARSE) -> int:
    """Serialized bytes of one leaf frame, length prefix included."""
    n = _LEN.size + _HEADER.size
    if kind == DENSE:
        return n + 4 * size
    if kind == DENSE_COO:
        return n + (4 + _index_nbytes(size)) * k
    if mode in ("int8", "tern"):
        n += _SCALE.size
    return n + _index_nbytes(size) * k + _value_nbytes(k, mode)


def arena_frame_bytes(seg, size: int, mode: str = "none") -> int:
    """Serialized bytes of one ARENA frame (length prefix included)."""
    k = sum(seg)
    n = _LEN.size + _HEADER.size + 4 * len(seg)     # header + seg table
    if mode in ("int8", "tern"):
        n += 4 * len(seg)                           # one scale per tensor
    return n + _index_nbytes(size) * k + _value_nbytes(k, mode)


def frame_bytes_static(seg, size: int, mode: str = "none") -> int:
    """Per-event wire bytes of a sparse arena message (envelope included),
    a pure function of ``(seg, size, mode)``."""
    return _ENVELOPE.size + arena_frame_bytes(seg, size, mode)


def dense_frame_bytes(nnz, size: int):
    """Frame bytes of a dense f32 leaf with ``nnz`` nonzeros: the cheaper of
    DENSE / DENSE_COO.  Works elementwise on numpy arrays of nnz."""
    coo = (4 + _index_nbytes(size)) * nnz
    body = np.where(coo < 4 * size, coo, 4 * size)
    return _LEN.size + _HEADER.size + body


def _dense_kind(nnz: int, size: int) -> int:
    """COO when (idx, value) pairs beat the dense f32 vector."""
    return (DENSE_COO
            if (4 + _index_nbytes(size)) * nnz < 4 * size else DENSE)


def frame_bytes(msgs, *, mode: str = "none", seg=None,
                envelope: bool = True) -> int:
    """Wire size of a message, equal to ``len(encode_message(...))``.

    Accepts one leaf or a list of them.  ``seg`` marks a SparseLeaf as an
    ARENA frame with that segmentation; without it the per-leaf SPARSE
    framing is counted.
    """
    if isinstance(msgs, SparseLeaf) or not isinstance(msgs, (list, tuple)):
        msgs = [msgs]
    total = _ENVELOPE.size if envelope else 0
    for m in msgs:
        if isinstance(m, SparseLeaf):
            if seg is not None:
                total += arena_frame_bytes(seg, int(m.size), mode)
            else:
                total += leaf_frame_bytes(m.k, m.size, mode, SPARSE)
        else:
            # counted on the device: only the scalar nnz crosses to the host
            total += int(dense_frame_bytes(int(torch.count_nonzero(m)),
                                           int(m.numel())))
    return total


def shard_frame_bytes_static(shard_spec, seg, mode: str = "none"):
    """Per-shard static wire bytes of one sharded sparse arena message.

    Shard ``s`` ships its own ARENA frame over its ``sizes[s]``-element
    sub-arena: its slice of the seg table, its tensors' scales, and indices
    rebased shard-local, so possibly NARROWER (``index_dtype`` derives from
    the shard's size).  The sum is the sharded run's exact per-event byte
    cost: each shard pays its own envelope and header.
    """
    return tuple(
        frame_bytes_static(shard_spec.shard_seg(seg, s), size, mode)
        for s, size in enumerate(shard_spec.sizes))


def encode_sharded_message(msg_type: int, sender: int, seq: int, msg, *,
                           shard_spec, mode: str = "none", seg=None,
                           aux: float = 0.0):
    """Route one arena message as ``S`` shard-local frames.

    The message splits by index range (``ShardSpec.split_by_shard``) and
    each piece encodes as its own complete message (one launch of the
    segmented quantize and one copy to the host on the card; an empty
    shard's frame is a header only, with none), so coordinator shard ``s``
    decodes ONLY its range, with the unsharded frame's per-tensor scales.
    Returns ``[(payload, shipped_pieces), ...]`` in shard order;
    ``ShardSpec.merge`` of the shipped pieces is bit-equal to the
    single-frame ``encode_message`` shipped leaf.
    """
    return [encode_message(msg_type, sender, seq, [piece], mode=mode,
                           seg=sub_seg, aux=aux)
            for piece, sub_seg in shard_spec.split_by_shard(msg, seg)]


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _host(t) -> np.ndarray:
    """A tensor (or array) on the host as numpy; bf16 as its u16 bits."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _pack_tern(codes: np.ndarray) -> bytes:
    """{-1, 0, +1} int8 -> 2-bit codes (two's complement), 4 per byte."""
    u = (codes.astype(np.int8) & 3).astype(np.uint8)
    pad = (-len(u)) % 4
    if pad:
        u = np.concatenate([u, np.zeros(pad, np.uint8)])
    u = u.reshape(-1, 4)
    return (u[:, 0] | (u[:, 1] << 2) | (u[:, 2] << 4)
            | (u[:, 3] << 6)).astype(np.uint8).tobytes()


def _unpack_tern(buf: bytes, k: int) -> np.ndarray:
    b = np.frombuffer(buf, np.uint8)
    u = np.empty((len(b), 4), np.uint8)
    for j in range(4):
        u[:, j] = (b >> (2 * j)) & 3
    codes = u.reshape(-1)[:k].astype(np.int8)
    codes[codes == 3] = -1
    return codes


def _pack_values(codes, mode: str) -> bytes:
    codes = _host(codes)
    if mode == "none":
        return np.asarray(codes, np.float32).tobytes()
    if mode == "tern":
        return _pack_tern(codes)
    return codes.tobytes()   # bf16 u16 bits, int8 codes


def _empty_arena_frame(leaf: SparseLeaf, mode: str):
    """An empty shard's frame: header only (k == 0)."""
    body = _HEADER.pack(0, MODES[mode], ARENA, 0, int(leaf.size))
    return _LEN.pack(len(body)) + body, leaf


def encode_arena_leaf_segments(leaf: SparseLeaf, mode: str, seg):
    """ARENA encoder as a plain per-segment loop: one ``quantize_parts``
    per tensor.  The semantics oracle :func:`pack_from_arena` is held to
    byte for byte (tests), and the simplest statement of the frame layout.
    Returns ``(frame_bytes, shipped)``."""
    seg = tuple(int(s) for s in seg)
    k, size = int(leaf.k), int(leaf.size)
    if sum(seg) != k:
        raise ValueError(f"seg {seg} sums to {sum(seg)}, message has {k}")
    if not seg:
        return _empty_arena_frame(leaf, mode)
    idx = _host(leaf.indices).astype(index_dtype(size))
    codes, scales, dq = [], [], []
    for part in torch.split(leaf.values.to(torch.float32), list(seg)):
        c, sc, d = quantize_parts(part, mode)
        codes.append(_host(c))
        scales.append(float(sc))
        dq.append(d)
    body = _HEADER.pack(len(seg), MODES[mode], ARENA, k, size)
    body += np.asarray(seg, np.uint32).tobytes()
    if mode in ("int8", "tern"):
        body += np.asarray(scales, np.float32).tobytes()
    body += idx.tobytes() + _pack_values(np.concatenate(codes), mode)
    shipped = SparseLeaf(values=torch.cat(dq), indices=leaf.indices,
                         size=size)
    return _LEN.pack(len(body)) + body, shipped


_PINNED = threading.local()


def _host_bytes(tail: torch.Tensor) -> bytes:
    """A ``uint8`` device buffer as bytes: one non-blocking copy into a
    pinned buffer owned by the calling thread, one wait on an event
    recorded after it, and the bytes copied out before the thread can
    reuse the buffer (the cluster's client threads encode concurrently)."""
    if tail.device.type == "cpu":
        return tail.numpy().tobytes()
    n = tail.numel()
    buf = getattr(_PINNED, "buf", None)
    if buf is None or buf.numel() < n:
        size = max(n, 2 * buf.numel() if buf is not None else 0)
        buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        _PINNED.buf = buf
    host = buf[:n]
    host.copy_(tail, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host.numpy().tobytes()


def pack_from_arena(leaf: SparseLeaf, mode: str, seg):
    """ARENA encode on the message's device (``kernels/wire_pack.py``).

    One ``frame_tail`` quantizes every segment with its own scale and
    writes the frame's tail (scales, narrowed indices, codes) into one
    buffer (one kernel launch on the card); it crosses to the host in one
    copy, the encode's one wait.  Byte for byte equal to
    :func:`encode_arena_leaf_segments`.  Returns ``(frame_bytes,
    shipped_leaf)``, the shipped values left on the device.
    """
    from repro_torch.kernels import wire_pack

    seg = tuple(int(s) for s in seg)
    k, size = int(leaf.k), int(leaf.size)
    if sum(seg) != k:
        raise ValueError(f"seg {seg} sums to {sum(seg)}, message has {k}")
    if not seg:
        return _empty_arena_frame(leaf, mode)
    tail, dq = wire_pack.frame_tail(leaf.values, leaf.indices, seg, mode,
                                    size)
    body = _HEADER.pack(len(seg), MODES[mode], ARENA, k, size)
    body += np.asarray(seg, np.uint32).tobytes() + _host_bytes(tail)
    shipped = SparseLeaf(values=dq, indices=leaf.indices, size=size)
    return _LEN.pack(len(body)) + body, shipped


def encode_arena_leaf(leaf: SparseLeaf, mode: str, seg):
    """Serialize one global-index arena message as an ARENA frame (each
    segment with its own scale), through :func:`pack_from_arena`.
    Returns ``(frame_bytes, shipped_leaf)``."""
    return pack_from_arena(leaf, mode, seg)


def encode_leaf(leaf_id: int, leaf, mode: str = "none", seg=None):
    """Serialize one leaf; returns ``(frame_bytes, shipped_leaf)``.

    ``shipped_leaf`` is exactly what :func:`decode_leaf` on the far side
    reconstructs.  A SparseLeaf with ``seg`` travels as a segmented ARENA
    frame; without it, as a per-leaf SPARSE frame; a dense tensor as a
    DENSE or DENSE_COO frame, unquantized.
    """
    if isinstance(leaf, SparseLeaf) and seg is not None:
        return encode_arena_leaf(leaf, mode, seg)
    if isinstance(leaf, SparseLeaf):
        codes, scale, dq = quantize_parts(leaf.values, mode)
        k, size = leaf.k, leaf.size
        idx = _host(leaf.indices).astype(index_dtype(size))
        body = _HEADER.pack(leaf_id, MODES[mode], SPARSE, k, size)
        if mode in ("int8", "tern"):
            body += _SCALE.pack(float(scale))
        body += idx.tobytes() + _pack_values(codes, mode)
        shipped = SparseLeaf(values=dq, indices=leaf.indices, size=size)
        return _LEN.pack(len(body)) + body, shipped

    flat = np.asarray(_host(leaf), np.float32).reshape(-1)
    nz = np.flatnonzero(flat)
    kind = _dense_kind(len(nz), flat.size)
    if kind == DENSE:
        body = _HEADER.pack(leaf_id, MODES["none"], DENSE,
                            flat.size, flat.size) + flat.tobytes()
    else:
        body = (_HEADER.pack(leaf_id, MODES["none"], DENSE_COO,
                             len(nz), flat.size)
                + nz.astype(index_dtype(flat.size)).tobytes()
                + flat[nz].tobytes())
    return _LEN.pack(len(body)) + body, leaf


def encode_message(msg_type: int, sender: int, seq: int, msgs=(),
                   *, mode: str = "none", seg=None, aux: float = 0.0):
    """Serialize a full message; returns ``(payload, shipped_msgs)``.

    ``msgs`` is the leaf list (the arena runtime ships exactly one leaf:
    the global-index arena message); ``seg`` routes SparseLeaf leaves
    through the segmented ARENA framing.
    """
    if isinstance(msgs, SparseLeaf) or not isinstance(msgs, (list, tuple)):
        msgs = [msgs]
    if seg is not None and sum(isinstance(m, SparseLeaf) for m in msgs) > 1:
        # the ARENA header reuses the leaf_id field as n_seg, so a message
        # holds at most ONE arena frame
        raise ValueError("arena (seg=) messages carry exactly one "
                         f"SparseLeaf; got {len(msgs)} leaves")
    frames, shipped = [], []
    for i, m in enumerate(msgs):
        frame, s = encode_leaf(i, m, mode, seg)
        frames.append(frame)
        shipped.append(s)
    payload = _ENVELOPE.pack(msg_type, sender, seq, aux, len(frames))
    return payload + b"".join(frames), shipped


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns -> f32, exactly (a bf16 is an f32's high half)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _sparse(vals: np.ndarray, idx: np.ndarray, size: int, device):
    return SparseLeaf(values=from_host(vals, device),
                      indices=from_host(idx, device), size=size)


def decode_leaf(buf, offset: int = 0, *, device=None):
    """Decode one leaf frame onto ``device`` (None = the card); returns
    ``(leaf_id, leaf, next_offset)``."""
    device = resolve_device(device)
    (blen,) = _LEN.unpack_from(buf, offset)
    offset += _LEN.size
    end = offset + blen
    leaf_id, mode_c, kind, k, size = _HEADER.unpack_from(buf, offset)
    offset += _HEADER.size
    mode = MODE_NAMES[mode_c]

    idt = index_dtype(size)
    if kind == ARENA:
        n_seg = leaf_id  # ARENA frames reuse the leaf_id field as n_seg
        seg = np.frombuffer(buf, np.uint32, n_seg, offset)
        offset += seg.nbytes
        scales = None
        if mode in ("int8", "tern"):
            scales = np.frombuffer(buf, np.float32, n_seg, offset)
            offset += scales.nbytes
        idx = np.frombuffer(buf, idt, k, offset).astype(np.int32)
        offset += k * np.dtype(idt).itemsize
        if mode == "none":
            vals = np.frombuffer(buf, np.float32, k, offset).copy()
        elif mode == "bf16":
            vals = _bf16_to_f32(np.frombuffer(buf, np.uint16, k, offset))
        else:
            if mode == "int8":
                codes = np.frombuffer(buf, np.int8, k, offset)
            else:  # tern
                codes = _unpack_tern(bytes(buf[offset:end]), k)
            vals = np.empty(k, np.float32)
            off = 0
            for s, sc in zip(seg, scales):
                # one f32 product per element, the encoder's q * s
                vals[off:off + s] = codes[off:off + s].astype(np.float32) \
                    * sc
                off += s
        return 0, _sparse(vals, idx, size, device), end
    if kind == DENSE:
        flat = np.frombuffer(buf, np.float32, size, offset).copy()
        return leaf_id, from_host(flat, device), end
    if kind == DENSE_COO:
        idx = np.frombuffer(buf, idt, k, offset)
        offset += idx.nbytes
        vals = np.frombuffer(buf, np.float32, k, offset)
        flat = np.zeros(size, np.float32)
        flat[idx] = vals
        return leaf_id, from_host(flat, device), end

    scale = np.float32(0.0)
    if mode in ("int8", "tern"):
        (scale,) = _SCALE.unpack_from(buf, offset)
        scale = np.float32(scale)
        offset += _SCALE.size
    idx = np.frombuffer(buf, idt, k, offset).astype(np.int32)
    offset += k * np.dtype(idt).itemsize
    if mode == "none":
        vals = np.frombuffer(buf, np.float32, k, offset).copy()
    elif mode == "bf16":
        vals = _bf16_to_f32(np.frombuffer(buf, np.uint16, k, offset))
    elif mode == "int8":
        vals = np.frombuffer(buf, np.int8, k, offset).astype(np.float32) \
            * scale
    else:  # tern
        codes = _unpack_tern(bytes(buf[offset:end]), k)
        vals = codes.astype(np.float32) * scale
    return leaf_id, _sparse(vals, idx, size, device), end


def decode_message(payload, *, device=None) -> Message:
    """Decode a whole message, its leaves onto ``device`` (None = the
    card)."""
    device = resolve_device(device)
    buf = memoryview(payload)
    msg_type, sender, seq, aux, n_leaves = _ENVELOPE.unpack_from(buf, 0)
    offset = _ENVELOPE.size
    leaves = [None] * n_leaves
    for _ in range(n_leaves):
        leaf_id, leaf, offset = decode_leaf(buf, offset, device=device)
        leaves[leaf_id] = leaf
    return Message(type=msg_type, sender=sender, seq=seq, aux=aux,
                   leaves=leaves)
