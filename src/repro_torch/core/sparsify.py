"""Top-k gradient sparsification primitives (PyTorch port of
``repro.core.sparsify``).

The paper selects "the top (100-R)% of |v|" per parameter tensor; as in the
reference, that is a static ``k = max(1, round(density * size))`` per tensor
and a fixed-size ``(values, indices)`` pair.

Ties: ``lax.top_k`` breaks ties toward the lower index, ``torch.topk``
promises no order.  Every exact selection here is therefore a STABLE
descending sort (:func:`topk_indices`), which gives the lower index first.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.arith import fma, rcp


class SparseLeaf(NamedTuple):
    """Fixed-size sparse representation of one flattened tensor."""

    values: torch.Tensor   # (k,) same dtype as source
    indices: torch.Tensor  # (k,) int32 into the flattened tensor
    size: int              # number of elements in the dense tensor

    @property
    def k(self) -> int:
        return self.values.shape[-1]

    def row(self, b: int) -> "SparseLeaf":
        """Lane ``b`` of a stacked ``(B, k)`` message."""
        return SparseLeaf(values=self.values[b], indices=self.indices[b],
                          size=self.size)


def density_to_k(size: int, density: float) -> int:
    """Static number of kept elements for a tensor of ``size`` elements."""
    if not (0.0 < density <= 1.0):
        raise ValueError(f"density must be in (0, 1], got {density}")
    return max(1, min(size, int(round(size * density))))


def topk_indices(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k largest ``keys`` along the last axis, ties to the
    lower position (``lax.top_k``'s order), as int64."""
    return torch.sort(keys, dim=-1, descending=True, stable=True)[1][..., :k]


def topk_select(x: torch.Tensor, k: int) -> SparseLeaf:
    """Exact top-k by magnitude over the flattened tensor."""
    flat = x.reshape(-1)
    idx = topk_indices(flat.abs(), k)
    return SparseLeaf(values=flat[idx], indices=idx.to(torch.int32),
                      size=flat.shape[0])


def topk_threshold(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest |x| (elements with |x| >= thr are the top-k)."""
    return torch.topk(x.reshape(-1).abs(), k).values[-1]


def topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask selecting exactly the top-k |x| positions (ties broken
    by index order, matching ``lax.top_k``)."""
    flat = x.reshape(-1)
    mask = torch.zeros(flat.shape, dtype=torch.bool, device=flat.device)
    mask[topk_indices(flat.abs(), k)] = True
    return mask.reshape(x.shape)


def sampled_threshold(x: torch.Tensor, density: float, *,
                      sample_size: int = 65536) -> torch.Tensor:
    """Estimate the top-``density`` magnitude threshold from a strided
    subsample (DGC).  The ceil stride makes the sample span the whole
    tensor.  (The reference's random-key sample has no counterpart: no
    caller of the port passes a key.)"""
    return sampled_threshold_rows(x.reshape(1, -1), density,
                                  sample_size=sample_size)[0]


def sampled_threshold_rows(x2d: torch.Tensor, density: float, *,
                           sample_size: int = 65536) -> torch.Tensor:
    """:func:`sampled_threshold` of each row of ``(S, n)``: ``(S,)``
    thresholds (the k-th largest sampled magnitude is one value whatever
    order the top-k finds it in)."""
    mag = x2d.abs()
    n = mag.shape[1]
    s = min(sample_size, n)
    stride = -(-n // s)
    sample = mag[:, ::stride]
    ks = max(1, int(round(sample.shape[1] * density)))
    return torch.topk(sample, ks, dim=1).values[:, -1]


# ---------------------------------------------------------------------------
# Wire quantization of sparse values
# ---------------------------------------------------------------------------

QUANTIZE_BITS = {"none": 32, "bf16": 16, "int8": 8, "tern": 2}


# the int8 scale's constants as XLA folds ``max / 127 + 1e-12``: fma(max,
# f32(1/127), f32(1e-12)); the kernel takes these same two floats
INT8_RCP = rcp(127.0)
INT8_EPS = float(np.float32(1e-12))


def _tern_sum(mag: torch.Tensor) -> torch.Tensor:
    """Float32 sums over the last axis of the tern scale's magnitudes.  On
    the CPU each row is taken left to right, the order in which XLA's CPU
    reduction adds short vectors (up to about 20 elements), so short
    segments match the reference bit for bit; longer ones XLA reorders, and
    there the scale agrees to a tolerance.  Elsewhere in the card's order,
    which depends on the length alone (``kernels.wire_pack.tern_sum``)."""
    if mag.device.type != "cpu":
        from repro_torch.kernels.wire_pack import tern_sum

        return tern_sum(mag)
    total = np.cumsum(mag.detach().numpy(), axis=-1, dtype=np.float32)
    return torch.from_numpy(np.ascontiguousarray(total[..., -1]))


def quantize_scales_plain(values2d: torch.Tensor, mode: str) -> torch.Tensor:
    """The wire scale of each row of ``(B, k)`` f32, ``(B, 1)``, on any
    device: int8's ``fma(max|v|, 1/127, 1e-12)`` (``arith.fma``), tern's
    ``sum|v| / max(nnz, 1)`` (:func:`_tern_sum`'s order), zeros for none
    and bf16.  The plain version of the segmented quantize's scales
    (``kernels.wire_pack.segment_quantize``), which compute these on the
    card."""
    if mode == "int8":
        return fma(values2d.abs().amax(dim=1, keepdim=True), INT8_RCP,
                   INT8_EPS)
    if mode == "tern":
        nnz = torch.clamp((values2d != 0.0).sum(dim=1, keepdim=True), min=1)
        total = _tern_sum(values2d.abs())
        return total.reshape(-1, 1) / nnz.to(torch.float32)
    if mode in ("none", "bf16"):
        return torch.zeros((values2d.shape[0], 1), dtype=torch.float32,
                           device=values2d.device)
    raise ValueError(f"unknown quantization mode {mode!r}")


def quantize_rows(values2d: torch.Tensor, mode: str):
    """(codes, scale, dequantized) of each row of ``(B, k)``, each row with
    its own scale (``(B, 1)``) -- THE quantization arithmetic, the
    segmented quantize with one segment per row (one launch on the card).

    none  -- float32 passthrough; codes == values
    bf16  -- bfloat16 wire; codes are the bf16 values
    int8  -- symmetric per-message int8 with one f32 scale
    tern  -- TernGrad-style {-1, 0, +1} * mean|v| over the nonzeros
    """
    values = values2d.to(torch.float32)
    if mode == "none":
        return values, quantize_scales_plain(values, mode), values
    from repro_torch.kernels import wire_pack

    codes, scale, deq = wire_pack.segment_quantize(
        values, (values.shape[1],), mode, codes="element")
    if mode == "bf16":
        codes = codes.view(torch.bfloat16)
    return codes, scale, deq


def quantize_parts(values: torch.Tensor, mode: str):
    """(codes, scale, dequantized) of one message, one scale over all of
    ``values``: :func:`quantize_rows` at B = 1."""
    codes, scale, deq = quantize_rows(values.reshape(1, -1), mode)
    return (codes.reshape(values.shape), scale.reshape(()),
            deq.reshape(values.shape))


def quantize_dequantize(values: torch.Tensor, mode: str):
    """Quantize sparse message values for the wire; returns (dequantized
    values, bits per value)."""
    return quantize_parts(values, mode)[2], QUANTIZE_BITS[mode]


def quantize_segments(values: torch.Tensor, mode: str, seg) -> torch.Tensor:
    """Segment-wise wire quantization of a concatenated value vector: each
    segment (one per parameter tensor) gets its own scale.  A stacked
    ``(B, k)`` batch of messages quantizes row by row: one scale per row
    per segment; one ``(k,)`` message is that batch at B = 1.  One launch
    of the segmented quantize on the card for the whole batch."""
    if mode == "none":
        return values
    if values.dim() == 1:
        return quantize_segments(values[None], mode, seg)[0]
    from repro_torch.kernels import wire_pack

    return wire_pack.segment_quantize(values.to(torch.float32), seg,
                                      mode).dq
