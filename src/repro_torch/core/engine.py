"""The compression engine: ONE pluggable top-k selector behind every DGS path
(PyTorch port of ``repro.core.engine``).

Three engines share the semantics contract of ``kernels/ref.py``:

* ``exact``     -- a stable descending sort over |x| (ties to the lower
                   index, as ``lax.top_k``).  The oracle.
* ``sampled``   -- DGC-style sampled-threshold estimate, a sort-free
                   compaction of the passers into <= 4k candidates, and an
                   exact top-k over only those.
* ``blockwise`` -- the kernel path: ``ops.hierarchical_topk`` (per-block
                   top-r candidates, kernel 2) for selection,
                   ``samomentum_fused`` (kernel 3) for the accumulate /
                   threshold / rescale pass, ``scatter_add`` (kernel 1) for
                   the support repair.  Exact whenever ``block_r >= k``.

``engine="auto"`` picks exact below ``sampled_threshold_above`` elements and
sampled at or above it.  The reference's ``interpret`` knob has no
counterpart: the device of the tensor decides between kernel and plain
version.  The row-wise selectors (``select_rows``) serve the mesh exchange
and wait for that slice.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import torch

from repro_torch.arith import fma, rcp

from .sparsify import (
    SparseLeaf,
    quantize_dequantize,
    quantize_segments,
    sampled_threshold,
    topk_indices,
    topk_select,
)


# ---------------------------------------------------------------------------
# spec + registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Everything a call site needs to say about how to compress.

    engine:  "exact" | "sampled" | "blockwise" | "auto"
    quantize: wire quantization mode for message VALUES
              ("none" | "bf16" | "int8" | "tern", see sparsify)
    sampled_threshold_above: auto-dispatch size cutoff
    sample_size: subsample size for the sampled threshold estimate
    block_r: per-block candidate count for blockwise (None = k, i.e. exact)
    """

    engine: str = "auto"
    quantize: str = "none"
    sampled_threshold_above: int = 1 << 20
    sample_size: int = 65536
    block_r: int | None = None

    @property
    def value_bits(self) -> int:
        return {"none": 32, "bf16": 16, "int8": 8, "tern": 2}[self.quantize]


DEFAULT_SPEC = CompressionSpec()
EXACT_SPEC = CompressionSpec(engine="exact")


@runtime_checkable
class SelectionEngine(Protocol):
    """One way of computing a top-k support: flat (n,) -> SparseLeaf of
    exactly k entries."""

    name: str

    def select(self, x: torch.Tensor, k: int) -> SparseLeaf: ...


ENGINES: dict[str, type] = {}


def register_engine(cls):
    ENGINES[cls.name] = cls
    return cls


def get_engine(name: str, spec: CompressionSpec = DEFAULT_SPEC
               ) -> SelectionEngine:
    """Instantiate a registered engine, configured from ``spec``."""
    try:
        cls = ENGINES[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; have {sorted(ENGINES)} + 'auto'")
    return cls.from_spec(spec)


def resolve_engine(spec: CompressionSpec, size: int) -> SelectionEngine:
    """Engine instance for a ``size``-element tensor (auto-dispatch)."""
    name = spec.engine
    if name == "auto":
        name = "sampled" if size >= spec.sampled_threshold_above else "exact"
    return get_engine(name, spec)


# ---------------------------------------------------------------------------
# the three engines
# ---------------------------------------------------------------------------

@register_engine
@dataclasses.dataclass(frozen=True)
class ExactEngine:
    """Stable-sort top-k over |x| -- the semantics oracle."""

    name = "exact"

    @classmethod
    def from_spec(cls, spec: CompressionSpec):
        return cls()

    def select(self, x, k):
        return topk_select(x, k)


def _threshold_compact_rows(x2d, thr, k: int, *, cap_factor: int = 4):
    """Exactly-k selection of threshold passers without a full-width sort.

    One streaming pass (cumsum rank + scatter) compacts the passers into at
    most ``cap = cap_factor * k`` candidate slots in index order; an exact
    top-k then runs over only those candidates.  Exact zeros never pass.
    Surplus passers beyond ``cap`` are dropped in index order; if fewer than
    k pass, the spare slots duplicate the strongest candidate with value 0
    (decode-neutral padding).

    x2d: (S, n); thr: (S, 1).  Returns (vals (S, k), idx (S, k) int32).
    """
    S, n = x2d.shape
    mag = x2d.abs()
    cap = int(min(n, cap_factor * k))
    mask = (mag >= thr) & (mag > 0.0)
    rank = torch.cumsum(mask, dim=1) - 1               # rank among passers
    ok = mask & (rank < cap)
    cols = torch.arange(n, device=x2d.device).expand(S, n)
    slot = torch.where(ok, rank, cap)                  # cap = spill column
    cidx = torch.full((S, cap + 1), -1, dtype=torch.int64, device=x2d.device)
    cidx.scatter_(1, slot, torch.where(ok, cols, -1))
    cidx = cidx[:, :cap]
    valid = cidx >= 0
    cvals = torch.where(valid, torch.gather(x2d, 1, cidx.clamp(min=0)), 0.0)
    sel = topk_indices(torch.where(valid, cvals.abs(), -1.0), k)
    idx = torch.gather(cidx, 1, sel)
    vals = torch.gather(cvals, 1, sel)
    invalid = idx < 0
    idx = torch.where(invalid, idx[:, :1].clamp(min=0), idx)
    vals = torch.where(invalid, 0.0, vals)
    return vals.to(x2d.dtype), idx.to(torch.int32)


@register_engine
@dataclasses.dataclass(frozen=True)
class SampledEngine:
    """DGC sampled-threshold estimation (Lin et al. 2017)."""

    name = "sampled"
    sample_size: int = 65536

    @classmethod
    def from_spec(cls, spec: CompressionSpec):
        return cls(sample_size=spec.sample_size)

    def select(self, x, k):
        flat = x.reshape(-1)
        thr = sampled_threshold(flat, k / flat.shape[0],
                                sample_size=self.sample_size)
        vals, idx = _threshold_compact_rows(flat[None], thr.reshape(1, 1), k)
        return SparseLeaf(values=vals[0], indices=idx[0],
                          size=flat.shape[0])


@register_engine
@dataclasses.dataclass(frozen=True)
class BlockwiseEngine:
    """Hierarchical block selection: each 1024-element block emits its
    local top-``r`` candidates (kernel 2); a library top-k over the nb*r
    candidates finishes the selection.  Exact whenever r >= k."""

    name = "blockwise"
    block_r: int | None = None

    @classmethod
    def from_spec(cls, spec: CompressionSpec):
        return cls(block_r=spec.block_r)

    def _plan(self, n: int, k: int) -> int | None:
        """Per-block candidate count ``r`` guaranteeing >= k REAL
        candidates, or None when the hierarchy cannot cover k."""
        from repro_torch.kernels.block_topk import BLOCK

        nb_real = -(-n // BLOCK)
        n_last = n - (nb_real - 1) * BLOCK
        r = min(BLOCK, max(1, k if self.block_r is None else self.block_r,
                           -(-k // nb_real)))
        while r < BLOCK and (nb_real - 1) * r + min(r, n_last) < k:
            r = min(BLOCK, r * 2)
        if (nb_real - 1) * r + min(r, n_last) < k:
            return None
        return r

    def select(self, x, k):
        from repro_torch.kernels import ops

        flat = x.reshape(-1)
        n = flat.shape[0]
        r = self._plan(n, k)
        if r is None:
            return topk_select(flat, k)
        vals, idx = ops.hierarchical_topk(flat, k=k, r=r)
        # _plan guarantees >= k real candidates, so idx < n; the clamp is
        # decode safety only
        return SparseLeaf(values=vals,
                          indices=idx.clamp(max=n - 1).to(torch.int32),
                          size=n)


# ---------------------------------------------------------------------------
# SAMomentum on top of a selection -- THE single rescale implementation
# ---------------------------------------------------------------------------

def velocity_accumulate(u, g, *, momentum: float, lr: float):
    """Paper Eq. (11): u <- m * u + eta * g, as ``fma(m, u, eta * g)``
    (the reference's rounding, see ``repro_torch.arith``)."""
    return fma(momentum, u, lr * g)


def samomentum_rescale(uacc, sent_mask, momentum: float):
    """Paper Alg. 3 line 11: sent coordinates keep their velocity, unsent
    are divided by m (as a multiply by the f32 reciprocal, the reference's
    rounding) so next step's ``m * u`` decay cancels."""
    return torch.where(sent_mask, uacc, uacc * rcp(momentum))


def support_mask(indices, size: int):
    """Boolean (size,) mask from a flat index set."""
    mask = torch.zeros(size, dtype=torch.bool, device=indices.device)
    mask[indices.to(torch.int64)] = True
    return mask


def quantize_leaf(leaf: SparseLeaf, mode: str) -> SparseLeaf:
    """Wire-quantize one message leaf's values (indices untouched)."""
    if mode == "none":
        return leaf
    vq, _ = quantize_dequantize(leaf.values, mode)
    return SparseLeaf(values=vq.to(leaf.values.dtype), indices=leaf.indices,
                      size=leaf.size)


def select(x, k: int, spec: CompressionSpec = DEFAULT_SPEC) -> SparseLeaf:
    """Top-k of a flat tensor through the dispatched engine (+ wire
    quantization)."""
    flat = x.reshape(-1)
    eng = resolve_engine(spec, int(flat.shape[0]))
    return quantize_leaf(eng.select(flat, k), spec.quantize)


def samomentum_step(u, g, *, momentum: float, lr: float, k: int,
                    spec: CompressionSpec = DEFAULT_SPEC):
    """One SAMomentum step on one tensor: accumulate -> select -> rescale.

    Returns (msg over the flattened tensor with ``spec.quantize`` applied,
    u_new shaped like ``u``; u_new never sees quantization error).
    """
    eng = resolve_engine(spec, int(u.numel()))
    if isinstance(eng, BlockwiseEngine):
        msg, u_new = _samomentum_step_blockwise(
            u, g, eng, momentum=momentum, lr=lr, k=k)
    else:
        uacc = velocity_accumulate(u, g, momentum=momentum, lr=lr)
        flat = uacc.reshape(-1)
        msg = eng.select(flat, k)
        mask = support_mask(msg.indices, flat.shape[0])
        u_new = samomentum_rescale(flat, mask, momentum).reshape(u.shape)
    return quantize_leaf(msg, spec.quantize), u_new


def _samomentum_step_blockwise(u, g, eng: BlockwiseEngine, *, momentum, lr,
                               k):
    """The kernel path: all three kernels in one step.

    1. ``hierarchical_topk`` picks the support of the accumulated velocity,
    2. ``samomentum_fused`` re-walks it once against the k-th candidate
       magnitude, called as the reference calls it, on ``(uacc, uacc)``
       with ``lr = 1 - m`` (m*uacc + (1-m)*uacc, evaluated, not shortcut),
    3. ``scatter_add`` repairs the coordinates that pass the threshold but
       are not shipped (ties, r < k): they are rescaled like any unsent one.
    """
    from repro_torch.kernels import ops

    uacc = velocity_accumulate(u, g, momentum=momentum, lr=lr)
    msg = eng.select(uacc.reshape(-1), k)
    thr = msg.values.abs().min()
    sent_dense, u_new = ops.samomentum_fused(
        uacc, uacc, thr, momentum=momentum, lr=1.0 - momentum)
    # extra = thresholded-but-not-shipped coordinates (0 on the support);
    # sent_dense is this step's own temporary, so it is updated in place
    extra = ops.scatter_add(sent_dense.reshape(-1), msg.indices, -msg.values)
    u_new = fma(extra, 1.0 / momentum - 1.0, u_new.reshape(-1))
    return msg, u_new.reshape(u.shape)


def quantize_arena(msg: SparseLeaf, mode: str, seg) -> SparseLeaf:
    """Wire-quantize a global-index arena message SEGMENT-WISE (one scale
    per tensor, ``seg`` = per-tensor entry counts)."""
    if mode == "none":
        return msg
    return SparseLeaf(values=quantize_segments(msg.values, mode, seg),
                      indices=msg.indices, size=msg.size)


def samomentum_step_arena(u, g, space, *, momentum: float, lr: float,
                          ks, spec: CompressionSpec = DEFAULT_SPEC):
    """SAMomentum over a packed arena: per-tensor steps on the leaf views,
    one global-index message (indices rebased by leaf offset) and one
    rescaled velocity arena."""
    vals, idxs, new_u = [], [], []
    for off, k, u_view, g_view in zip(
            space.offsets, ks, space.views(u), space.views(g)):
        msg, u_new = samomentum_step(u_view, g_view, momentum=momentum,
                                     lr=lr, k=k, spec=spec)
        vals.append(msg.values)
        idxs.append(msg.indices + off)
        new_u.append(u_new.reshape(-1))
    return (SparseLeaf(values=torch.cat(vals), indices=torch.cat(idxs),
                       size=space.total),
            torch.cat(new_u))
