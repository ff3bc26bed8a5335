"""The parts of the wire codec the simulator uses (PyTorch port of
``repro.cluster.wire``): the in-process quantizer and the byte formulas.

Frame layout, as in the reference: a 17-byte envelope, then per frame a
4-byte length prefix and a 12-byte header; an ARENA frame (one global-index
sparse message over the whole arena) adds a u32 per-tensor entry count and,
for int8/tern, one f32 scale per tensor; indices are u8/u16/u32 by arena
size; values are f32 / bf16 / i8 / 2-bit codes.  The formulas below are the
reference's, so byte totals agree exactly.  Encode/decode wait for the
cluster slice.
"""
from __future__ import annotations

import struct

import numpy as np

from repro_torch.core.sparsify import SparseLeaf, quantize_segments

# leaf kinds
SPARSE, DENSE, DENSE_COO, ARENA = 0, 1, 2, 3

_ENVELOPE = struct.Struct("<BIIfI")     # 17 bytes
_LEN = struct.Struct("<I")              # 4-byte frame length prefix
_HEADER = struct.Struct("<HBBII")       # 12-byte frame header
_SCALE = struct.Struct("<f")

ENVELOPE_BYTES = _ENVELOPE.size


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
