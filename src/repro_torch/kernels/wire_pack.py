"""The codec's value pipeline: kernel 5 (``wire_codes``) and kernel 6
(``tern_pack``) of the port, in ``csrc/wire_pack.cu``.

Replace the TPU kernels of ``repro/kernels/wire_pack.py``: the bf16, int8
and tern code kernels that ``_codes_pallas`` launches, and the 2-bit tern
packer of ``_pack_tern_pallas``.

:func:`quantize_pack` is the port of the reference's entry point of the same
name.  The per-segment scales are :func:`repro_torch.core.sparsify.
quantize_scales` of each segment, the scale arithmetic of ``quantize_rows``
itself, so the codec's shipped values equal the simulator's
``quantize_message`` bit for bit; the kernel only recomputes the elementwise
codes and dequantized values from those scales.

Wire codes: f32 values (none), the bf16 bit patterns as int16 (the same 16
bits, which numpy views as uint16 after the copy to the host), int8 codes,
or the ``ceil(k / 4)`` uint8 bytes of the packed tern codes.

Each wrapper takes a CPU tensor to its plain version and launches its
kernel for a CUDA tensor; anything else raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.sparsify import quantize_scales
from repro_torch.device import from_host

from . import build

MODES = {"bf16": 1, "int8": 2, "tern": 3}    # the wire's mode codes

INFO = build.KernelInfo(
    name="wire_codes",
    source="src/repro_torch/kernels/csrc/wire_pack.cu",
    replaces="src/repro/kernels/wire_pack.py:87")

PACK_INFO = build.KernelInfo(
    name="tern_pack",
    source="src/repro_torch/kernels/csrc/wire_pack.cu",
    replaces="src/repro/kernels/wire_pack.py:111")


@functools.lru_cache(maxsize=64)
def _seg_ends(seg: tuple, device: torch.device) -> torch.Tensor:
    """The segment ends on ``device``: a run's segmentation is static, so
    it crosses to the card once per segmentation instead of at every
    call.  Nothing writes the cached tensor."""
    return from_host(np.cumsum(seg, dtype=np.int64), device)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``(x > 0) - (x < 0)`` in f32: +0 for both zeros (and for NaN)."""
    return (x > 0).to(torch.float32) - (x < 0).to(torch.float32)


def wire_codes_plain(values: torch.Tensor, scales: torch.Tensor, seg,
                     mode: str):
    """Plain PyTorch version of kernel 5: ``(codes, dq)`` of a flat f32
    message, each segment with its own scale (``scales``: one per segment;
    unused for bf16)."""
    if mode == "bf16":
        b = values.to(torch.bfloat16)
        return b.view(torch.int16), b.to(torch.float32)
    s = torch.repeat_interleave(
        scales, torch.as_tensor(seg, dtype=torch.int64, device=scales.device),
        output_size=values.shape[0])
    if mode == "int8":
        q = torch.clamp(torch.round(values / s), -127, 127)
    elif mode == "tern":
        q = _sign(values)
    else:
        raise ValueError(f"wire_codes: no codes for mode {mode!r}")
    return q.to(torch.int8), q * s


def wire_codes(values: torch.Tensor, scales: torch.Tensor, seg, mode: str):
    """Codes and dequantized values of a flat f32 message.  CPU -> plain
    version, CUDA -> kernel 5 (one launch)."""
    seg = tuple(int(s) for s in seg)
    if values.dim() != 1 or sum(seg) != values.shape[0] \
            or scales.shape != (len(seg),):
        raise ValueError(f"wire_codes: values {tuple(values.shape)}, scales "
                         f"{tuple(scales.shape)}, seg of {len(seg)} summing "
                         f"to {sum(seg)}")
    if mode not in MODES:
        raise ValueError(f"wire_codes: no codes for mode {mode!r}")
    if values.device.type == "cpu":
        return wire_codes_plain(values, scales, seg, mode)
    if values.device.type != "cuda":
        raise ValueError(f"wire_codes: no kernel for {values.device}")
    build.require(values, "values", torch.float32, values.device)
    build.require(scales, "scales", torch.float32, values.device)
    if len(seg) * 12 > 48 * 1024:
        raise ValueError(f"wire_codes: {len(seg)} segments exceed the "
                         f"kernel's shared memory")
    k = values.shape[0]
    codes = torch.empty(k, dtype=torch.int16 if mode == "bf16"
                        else torch.int8, device=values.device)
    dq = torch.empty(k, dtype=torch.float32, device=values.device)
    ends = _seg_ends(seg, values.device)
    rc = build.library().wire_codes(
        values.data_ptr(), k, MODES[mode], scales.data_ptr(), ends.data_ptr(),
        len(seg), codes.data_ptr(), dq.data_ptr(), build.stream())
    build.check(rc, INFO.name)
    build.count(INFO)
    return codes, dq


def tern_pack_plain(codes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel 6: ``(k,)`` int8 sign codes ->
    ``(ceil(k / 4),)`` uint8, four 2-bit fields per byte, first code in the
    low bits, the tail padded with zero codes."""
    u = codes.to(torch.int32) & 3
    pad = (-u.shape[0]) % 4
    if pad:
        u = torch.nn.functional.pad(u, (0, pad))
    u = u.view(-1, 4)
    return (u[:, 0] | (u[:, 1] << 2) | (u[:, 2] << 4)
            | (u[:, 3] << 6)).to(torch.uint8)


def tern_pack(codes: torch.Tensor) -> torch.Tensor:
    """Pack tern sign codes for the wire.  CPU -> plain version, CUDA ->
    kernel 6 (one launch)."""
    if codes.dim() != 1:
        raise ValueError(f"tern_pack: shape {tuple(codes.shape)}")
    if codes.device.type == "cpu":
        return tern_pack_plain(codes)
    if codes.device.type != "cuda":
        raise ValueError(f"tern_pack: no kernel for {codes.device}")
    build.require(codes, "codes", torch.int8, codes.device)
    k = codes.shape[0]
    out = torch.empty((k + 3) // 4, dtype=torch.uint8, device=codes.device)
    rc = build.library().tern_pack(codes.data_ptr(), k, out.data_ptr(),
                                   build.stream())
    build.check(rc, PACK_INFO.name)
    build.count(PACK_INFO)
    return out


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
    if mode == "bf16":
        scales = torch.zeros(len(seg), device=values.device)
    else:
        scales = torch.cat([
            quantize_scales(part[None], mode).reshape(1)
            for part in torch.split(values, list(seg))])
    codes, dq = wire_codes(values.contiguous(), scales, seg, mode)
    if mode == "tern":
        codes = tern_pack(codes)
    return codes, scales, dq


def narrow_indices(indices, *, size: int) -> np.ndarray:
    """The index block on the host, in the narrowest unsigned type a
    ``size``-element arena needs (u8 / u16 / u32, ``wire.index_dtype``'s
    rule): one copy of the int32 indices to the host, then a numpy cast."""
    if size <= 1 << 8:
        dtype = np.uint8
    elif size <= 1 << 16:
        dtype = np.uint16
    else:
        dtype = np.uint32
    if isinstance(indices, torch.Tensor):
        indices = indices.cpu().numpy()
    return np.asarray(indices).astype(dtype)
