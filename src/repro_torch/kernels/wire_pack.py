"""Every wire quantize of the port: one segmented quantize kernel,
``csrc/wire_pack.cu``, rows 5 and 6 of the port's kernel table.

Replaces the TPU kernels of ``repro/kernels/wire_pack.py``: the bf16, int8
and tern code kernels that ``_codes_pallas`` launches (row 5) and the 2-bit
tern packer of ``_pack_tern_pallas`` (row 6), together with the per-segment
scale reductions the reference leaves to XLA.  One launch quantizes a
``(B, k)`` batch of messages, each row cut into the same static segments
(one per parameter tensor), each (row, segment) with its own scale, and
writes the scales, the shipped (dequantized) values and, on request, the
wire codes.  The simulator's quantizer (``sparsify.quantize_rows``,
``quantize_segments``) and the codec's
(:func:`quantize_pack`, :func:`frame_tail`) are all this one function, so
the codec and the simulator agree by construction.

Wire codes: the bf16 bit patterns as int16 (the same 16 bits, which numpy
views as uint16 after the copy to the host), int8 codes, tern signs as int8
(``codes="element"``) or packed four to a byte (``codes="packed"``,
``ceil(k / 4)`` bytes a row).

The tern scale's float32 sum: on the CPU left to right (``sparsify.
_tern_sum``, the reference's order for short segments); on the card in the
kernel's order, which depends on the segment's length alone
(:func:`tern_sum` is its plain version).

Each wrapper takes a CPU tensor to its plain version and launches the
kernel for a CUDA tensor; anything else raises.  The launch counters: one
per launch, on :data:`PACK_INFO` when the launch packs tern codes (row 6's
function), else on :data:`INFO`; a segment longer than :data:`CHUNK` adds
the partial-sum launch before it.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.sparsify import (INT8_EPS, INT8_RCP,
                                       quantize_scales_plain)
from repro_torch.device import from_host

from . import build

MODES = {"none": 0, "bf16": 1, "int8": 2, "tern": 3}    # the wire's codes
CODE_FORMS = {None: 0, "element": 1, "packed": 2}
LANES = 1024          # lanes of the tern sum in one chunk
CHUNK = 8 * LANES     # elements per chunk: the kernel's order and its CTA

_SOURCE = "src/repro_torch/kernels/csrc/wire_pack.cu"
INFO = build.KernelInfo(
    name="segment_quantize", source=_SOURCE,
    replaces="src/repro/kernels/wire_pack.py:87")
# the launches that pack tern codes: TPU kernel 6's function
PACK_INFO = build.KernelInfo(
    name="segment_quantize_tern_pack", source=_SOURCE,
    replaces="src/repro/kernels/wire_pack.py:111")


class Quantized(NamedTuple):
    codes: torch.Tensor | None    # (B, k), or (B, ceil(k / 4)) packed
    scales: torch.Tensor          # (B, n_seg) f32, zeros for bf16
    dq: torch.Tensor              # (B, k) f32 shipped values


@functools.lru_cache(maxsize=64)
def _plan(seg: tuple) -> tuple:
    """``(chunks per segment, n_work, longest segment)``: a segment of n
    elements is ``max(1, ceil(n / CHUNK))`` chunks, one CTA each."""
    chunks = tuple(max(1, -(-n // CHUNK)) for n in seg)
    return chunks, sum(chunks), max(seg, default=0)


@functools.lru_cache(maxsize=64)
def _seg_table(seg: tuple, device: torch.device) -> torch.Tensor:
    """The segment ends then the cumulative chunk counts (from 0), int64
    on ``device``: a run's segmentation is static, so it crosses to the
    card once per segmentation instead of at every call.  Nothing writes
    the cached tensor."""
    chunks = _plan(seg)[0]
    table = np.concatenate([np.cumsum(seg, dtype=np.int64), [0],
                            np.cumsum(chunks, dtype=np.int64)])
    return from_host(table.astype(np.int64), device)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``(x > 0) - (x < 0)`` in f32: +0 for both zeros (and for NaN)."""
    return (x > 0).to(torch.float32) - (x < 0).to(torch.float32)


def tern_sum(mag: torch.Tensor) -> torch.Tensor:
    """Float32 sums over the last axis in the kernel's order, on any
    device: each row is padded with +0 to whole chunks of :data:`CHUNK`;
    in a chunk, lane j of :data:`LANES` adds elements j, j + LANES, ...
    left to right from +0; a halving tree combines the lanes (lane l +
    lane l + h, h = LANES / 2, ..., 1); the chunks' sums combine left to
    right.  ``mag`` is ``(..., n)`` magnitudes; returns ``(...)``."""
    n = mag.shape[-1]
    nc = max(1, -(-n // CHUNK))
    x = torch.nn.functional.pad(mag.to(torch.float32), (0, nc * CHUNK - n))
    x = x.reshape(*mag.shape[:-1], nc, CHUNK // LANES, LANES)
    acc = torch.zeros(x.shape[:-2] + (LANES,), dtype=torch.float32,
                      device=mag.device)
    for i in range(CHUNK // LANES):
        acc = acc + x[..., i, :]
    h = LANES // 2
    while h:
        acc = acc[..., :h] + acc[..., h:2 * h]
        h //= 2
    parts = acc[..., 0]
    total = parts[..., 0]
    for c in range(1, nc):
        total = total + parts[..., c]
    return total


def wire_codes_plain(values: torch.Tensor, scales: torch.Tensor, seg,
                     mode: str):
    """``(codes, dq)`` of ``(..., k)`` f32 messages, each segment with its
    own scale (``scales``: ``(..., n_seg)``; unused for bf16).  An int8
    code of a NaN quotient is 0."""
    if mode == "bf16":
        b = values.to(torch.bfloat16)
        return b.view(torch.int16), b.to(torch.float32)
    s = torch.repeat_interleave(
        scales, torch.as_tensor(seg, dtype=torch.int64, device=scales.device),
        dim=-1, output_size=values.shape[-1])
    if mode == "int8":
        q = torch.clamp(torch.round(values / s), -127, 127)
        codes = torch.nan_to_num(q, nan=0.0).to(torch.int8)
    elif mode == "tern":
        q = _sign(values)
        codes = q.to(torch.int8)
    else:
        raise ValueError(f"wire_codes: no codes for mode {mode!r}")
    return codes, q * s


def tern_pack_plain(codes: torch.Tensor) -> torch.Tensor:
    """``(..., k)`` int8 sign codes -> ``(..., ceil(k / 4))`` uint8, four
    2-bit fields per byte, first code in the low bits, the tail padded with
    zero codes."""
    u = codes.to(torch.int32) & 3
    pad = (-u.shape[-1]) % 4
    if pad:
        u = torch.nn.functional.pad(u, (0, pad))
    u = u.reshape(*u.shape[:-1], -1, 4)
    return (u[..., 0] | (u[..., 1] << 2) | (u[..., 2] << 4)
            | (u[..., 3] << 6)).to(torch.uint8)


def segment_quantize_plain(values2d: torch.Tensor, seg, mode: str, *,
                           codes=None) -> Quantized:
    """Plain PyTorch version of the kernel: ``quantize_scales_plain`` of
    each segment, then :func:`wire_codes_plain` and, for packed codes,
    :func:`tern_pack_plain`."""
    seg = tuple(int(s) for s in seg)
    scales = torch.cat([quantize_scales_plain(part, mode) for part in
                        torch.split(values2d, list(seg), dim=1)], dim=1)
    c, d = wire_codes_plain(values2d, scales, seg, mode)
    if codes == "packed":
        c = tern_pack_plain(c)
    return Quantized(c if codes else None, scales, d)


def _ptr(t):
    return None if t is None else t.data_ptr()


def launcher(x, seg, mode, *, scales, dq, codes, code_stride, form,
             idx=None, idx_out=None, idx_width=0):
    """The C entry bound to its operands: ``(call, launches)``.  ``x`` is
    ``(B, k)`` f32 with unit column stride; the outputs are tensors made
    beforehand (None for an output not written; a tensor's first byte is
    where the entry writes), ``code_stride`` the codes' row stride in
    bytes, ``form`` a key of :data:`CODE_FORMS`.  ``call()`` makes the
    launch (two where a segment is longer than :data:`CHUNK` and the mode
    reduces a scale: ``launches``) and returns the entry's status; it
    neither checks nor counts, so the wrappers do that and a timing can
    call it alone."""
    B, k = x.shape
    _, n_work, longest = _plan(seg)
    table = _seg_table(seg, x.device)
    multi = mode in ("int8", "tern") and longest > CHUNK
    partial = (torch.empty((B, n_work, 4), dtype=torch.float32,
                           device=x.device) if multi else None)
    operands = (x, table, scales, dq, codes, idx, idx_out, partial)
    args = (x.data_ptr(), x.stride(0), B, k, table.data_ptr(),
            table.data_ptr() + 8 * len(seg), len(seg), n_work, int(multi),
            MODES[mode], INT8_RCP, INT8_EPS, _ptr(scales), _ptr(dq), k,
            _ptr(codes), code_stride, CODE_FORMS[form], _ptr(idx),
            _ptr(idx_out), idx_width, _ptr(partial), build.stream())
    lib = build.library()

    def call(_operands=operands):      # the call keeps its operands alive
        return lib.segment_quantize(*args)
    return call, 2 if multi else 1


def _launch(x, seg, mode, *, form, **outputs):
    """One checked and counted call of the C entry (:func:`launcher`)."""
    call, launches = launcher(x, seg, mode, form=form, **outputs)
    info = PACK_INFO if form == "packed" else INFO
    build.check(call(), info.name)
    build.count(info, launches)


def _check(values2d, seg, mode, codes):
    if values2d.dim() != 2 or sum(seg) != values2d.shape[1] or not seg:
        raise ValueError(f"segment_quantize: values {tuple(values2d.shape)}, "
                         f"seg of {len(seg)} summing to {sum(seg)}")
    if mode not in ("bf16", "int8", "tern"):
        raise ValueError(f"segment_quantize: no codes for mode {mode!r}")
    if codes not in CODE_FORMS or (codes == "packed" and mode != "tern"):
        raise ValueError(f"segment_quantize: codes={codes!r} for {mode}")


def segment_quantize(values2d: torch.Tensor, seg, mode: str, *,
                     codes=None) -> Quantized:
    """Quantize each row of ``(B, k)`` f32 segment-wise (``seg``: the
    per-tensor entry counts, ``sum(seg) == k``): the scales ``(B, n_seg)``,
    the shipped values ``(B, k)`` and the codes
    (``codes``: None, ``"element"`` or, for tern, ``"packed"``).  CPU ->
    plain version, CUDA -> the kernel (one launch; two where a segment is
    longer than :data:`CHUNK` and the mode reduces a scale)."""
    seg = tuple(int(s) for s in seg)
    _check(values2d, seg, mode, codes)
    if values2d.device.type == "cpu":
        return segment_quantize_plain(values2d, seg, mode, codes=codes)
    if values2d.device.type != "cuda":
        raise ValueError(f"segment_quantize: no kernel for "
                         f"{values2d.device}")
    x = values2d
    if x.shape[1] > 1 and x.stride(1) != 1:
        x = x.contiguous()
    build.require(x, "values", torch.float32, x.device, contiguous=False)
    B, k = x.shape
    dev = x.device
    scales = torch.empty((B, len(seg)), dtype=torch.float32, device=dev)
    out = torch.empty((B, k), dtype=torch.float32, device=dev)
    code_t, stride = None, 0
    if codes == "packed":
        code_t = torch.empty((B, (k + 3) // 4), dtype=torch.uint8, device=dev)
        stride = (k + 3) // 4
    elif codes == "element":
        code_t = torch.empty((B, k), dtype=torch.int16 if mode == "bf16"
                             else torch.int8, device=dev)
        stride = k * code_t.element_size()
    _launch(x, seg, mode, scales=scales, dq=out, codes=code_t,
            code_stride=stride, form=codes)
    return Quantized(code_t, scales, out)


def quantize_pack(values: torch.Tensor, *, mode: str, seg):
    """``(wire_codes, scales, shipped)`` of one arena message: the
    reference's contract.

    ``values`` is the message's ``(k,)`` value vector, ``seg`` its
    per-tensor segmentation (``sum(seg) == k``; each segment quantizes with
    its own scale).  ``scales`` is ``(n_seg,)`` f32, zeros for none and
    bf16, which ship none; ``shipped`` is the ``(k,)`` f32 dequantized
    values, bit for bit what the decoder on the far side reconstructs.
    """
    values = values.to(torch.float32)
    seg = tuple(int(s) for s in seg)
    if sum(seg) != values.shape[0]:
        raise ValueError(f"quantize_pack: seg sums to {sum(seg)}, message "
                         f"has {values.shape[0]} values")
    if mode == "none":
        return values, torch.zeros(len(seg), device=values.device), values
    q = segment_quantize(values[None], seg, mode,
                         codes="packed" if mode == "tern" else "element")
    return q.codes[0], q.scales[0], q.dq[0]


def index_width(size: int) -> int:
    """Bytes per index of a ``size``-element arena (``wire.index_dtype``'s
    rule): 1, 2 or 4."""
    return 1 if size <= 1 << 8 else 2 if size <= 1 << 16 else 4


def narrow_indices(indices, *, size: int) -> np.ndarray:
    """The index block on the host, in the narrowest unsigned type a
    ``size``-element arena needs (u8 / u16 / u32): one copy of the int32
    indices to the host, then a numpy cast."""
    dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32}[index_width(size)]
    if isinstance(indices, torch.Tensor):
        indices = indices.cpu().numpy()
    return np.asarray(indices).astype(dtype)


def _tail_layout(k: int, n_seg: int, mode: str, size: int):
    """Byte offsets of an ARENA frame's tail: (index block, codes, end)."""
    idx_off = 4 * n_seg if mode in ("int8", "tern") else 0
    code_off = idx_off + index_width(size) * k
    code_bytes = {"none": 4 * k, "bf16": 2 * k, "int8": k,
                  "tern": (k + 3) // 4}[mode]
    return idx_off, code_off, code_off + code_bytes


def frame_tail_plain(values, indices, seg, mode: str, size: int):
    """Plain version of :func:`frame_tail`, on any device."""
    values = values.to(torch.float32)
    if mode == "none":
        scales, codes, dq = None, values, values
    else:
        q = segment_quantize_plain(
            values[None], seg, mode,
            codes="packed" if mode == "tern" else "element")
        scales, codes, dq = q.scales[0], q.codes[0], q.dq[0]
    parts = ([scales.cpu().numpy().tobytes()] if mode in ("int8", "tern")
             else [])
    parts += [narrow_indices(indices, size=size).tobytes(),
              codes.cpu().numpy().tobytes()]
    tail = torch.frombuffer(bytearray(b"".join(parts)), dtype=torch.uint8)
    return tail.to(values.device), dq


def frame_tail(values: torch.Tensor, indices: torch.Tensor, seg, mode: str,
               size: int):
    """An ARENA frame's bytes after its segment table, in frame order, in
    one ``uint8`` buffer on the message's device: the scales (int8 and
    tern), the indices narrowed to ``index_width(size)`` bytes, the value
    codes (f32 for none, bf16 bits, int8, packed tern).  Returns ``(tail,
    shipped)``, ``shipped`` the ``(k,)`` f32 values the far side decodes.
    CPU -> plain version, CUDA -> one launch of the kernel."""
    seg = tuple(int(s) for s in seg)
    k = values.shape[0]
    if values.dim() != 1 or indices.shape != (k,) or sum(seg) != k \
            or not seg or mode not in MODES:
        raise ValueError(f"frame_tail: values {tuple(values.shape)}, "
                         f"indices {tuple(indices.shape)}, seg of {len(seg)} "
                         f"summing to {sum(seg)}, mode {mode!r}")
    if values.device.type == "cpu":
        return frame_tail_plain(values, indices, seg, mode, size)
    if values.device.type != "cuda":
        raise ValueError(f"frame_tail: no kernel for {values.device}")
    x = values.to(torch.float32).contiguous()
    idx = indices.to(torch.int32).contiguous()
    build.require(x, "values", torch.float32, x.device)
    build.require(idx, "indices", torch.int32, x.device)
    idx_off, code_off, end = _tail_layout(k, len(seg), mode, size)
    tail = torch.empty(end, dtype=torch.uint8, device=x.device)
    dq = x if mode == "none" else torch.empty_like(x)
    _launch(x[None], seg, mode,
            scales=tail if mode in ("int8", "tern") else None,
            dq=None if mode == "none" else dq,
            codes=tail[code_off:], code_stride=end - code_off,
            form="packed" if mode == "tern" else "element",
            idx=idx, idx_out=tail[idx_off:code_off],
            idx_width=index_width(size))
    return tail, dq
