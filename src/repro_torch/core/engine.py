"""The compression engine: ONE pluggable top-k selector behind every DGS path
(PyTorch port of ``repro.core.engine``).

Three engines share the semantics contract of ``kernels/ref.py``:

* ``exact``     -- a stable descending sort over |x| (ties to the lower
                   index, as ``lax.top_k``).  The oracle.
* ``sampled``   -- DGC-style sampled-threshold estimate, a sort-free
                   compaction of the passers into <= 4k candidates, and an
                   exact top-k over only those.
* ``blockwise`` -- the kernel path: for selection, a row of at most
                   ``block_topk.ROW_MAX`` elements under an exact plan goes
                   through ``block_topk.row_topk_rows`` (kernel 2's row
                   regime: the row's exact top-k in one pass; in
                   :func:`samomentum_step_rows` the whole step's, through
                   ``block_topk.samomentum_row_topk_rows``), any other
                   through ``ops.hierarchical_topk_rows`` (per-block top-r
                   candidates, kernel 2, then a candidate top-k);
                   ``samomentum_fused`` (kernel 3) for the threshold /
                   rescale pass, ``scatter_add_rows`` (kernel 4) and one
                   fused multiply-add for the support repair.  Exact
                   whenever ``block_r >= k``.

``engine="auto"`` picks exact below ``sampled_threshold_above`` elements and
sampled at or above it.  The reference's ``interpret`` knob has no
counterpart: the device of the tensor decides between kernel and plain
version.

Every engine selects row-wise (``select_rows``, ``(S, n)`` -> per-row
top-k), the counterpart of the reference's ``vmap`` over rows: the batched
event loop runs its whole batch through one call, and the blockwise engine
then launches each kernel once for all rows.  The flat ``select`` and the
serial SAMomentum steps are the row-wise ones at B = 1, so the serial and
the batched loop share one code path and cannot drift apart in their bits.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import torch

from repro_torch.arith import rcp

from .sparsify import (
    SparseLeaf,
    quantize_dequantize,
    quantize_segments,
    quantize_rows,
    sampled_threshold_rows,
    topk_indices,
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
    """One way of computing a top-k support.

    select(x, k)        flat (n,) -> SparseLeaf of exactly k entries
    select_rows(x2d, k) (S, n)    -> (vals (S, k), idx (S, k) int32, local
                                      per-row indices)
    """

    name: str

    def select(self, x: torch.Tensor, k: int) -> SparseLeaf: ...

    def select_rows(self, x2d: torch.Tensor, k: int): ...


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


def _select_flat(eng, x, k: int) -> SparseLeaf:
    """An engine's flat ``select``: its ``select_rows`` at B = 1."""
    flat = x.reshape(-1)
    vals, idx = eng.select_rows(flat[None], k)
    return SparseLeaf(values=vals[0], indices=idx[0], size=flat.shape[0])


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

    select = _select_flat

    def select_rows(self, x2d, k):
        idx = topk_indices(x2d.abs(), k)
        return torch.gather(x2d, 1, idx), idx.to(torch.int32)


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

    select = _select_flat

    def select_rows(self, x2d, k):
        thr = sampled_threshold_rows(x2d, k / x2d.shape[1],
                                     sample_size=self.sample_size)
        return _threshold_compact_rows(x2d, thr[:, None], k)


@register_engine
@dataclasses.dataclass(frozen=True)
class BlockwiseEngine:
    """Hierarchical block selection: each 1024-element block emits its
    local top-``r`` candidates (kernel 2); a library top-k over the nb*r
    candidates finishes the selection.  Exact whenever r >= k.

    Where the plan is exact (r >= k, or r = BLOCK: every element a
    candidate) and a row holds at most ``ROW_MAX`` elements, the row
    regime gives the same answer in one pass (``row_topk_rows``: one CTA
    a row, no padding, no candidate sort), so the row takes it; longer
    rows and inexact plans keep the hierarchy."""

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

    select = _select_flat

    def row_regime(self, n: int, k: int) -> bool:
        """Whether a row of ``n`` takes the row regime at ``k``: it fits
        one CTA and the plan is exact (r >= k, or r = BLOCK)."""
        from repro_torch.kernels import block_topk

        r = self._plan(n, k)
        return n <= block_topk.ROW_MAX and r is not None \
            and (r >= k or r == block_topk.BLOCK)

    def select_rows(self, x2d, k):
        from repro_torch.kernels import block_topk, ops

        n = x2d.shape[1]
        if self.row_regime(n, k):
            return block_topk.row_topk_rows(x2d, k)
        r = self._plan(n, k)
        if r is None:
            return ExactEngine().select_rows(x2d, k)
        vals, idx = ops.hierarchical_topk_rows(x2d, k=k, r=r)
        # _plan guarantees >= k real candidates, so idx < n; the clamp is
        # decode safety only
        return vals, idx.clamp(max=n - 1).to(torch.int32)


# ---------------------------------------------------------------------------
# SAMomentum on top of a selection -- THE single rescale implementation
# ---------------------------------------------------------------------------

def velocity_accumulate(u, g, *, momentum: float, lr):
    """Paper Eq. (11): u <- m * u + eta * g, as ``fma(m, u, eta * g)``
    (the reference's rounding, see ``repro_torch.arith``), a new
    contiguous tensor.  ``lr`` is a float, or a float32 ``(B, 1)`` tensor
    (one learning rate per row of the batched loop).  On the card, one
    float32 kernel launch (``samomentum_kernel.velocity_accumulate``)."""
    from repro_torch.kernels import samomentum_kernel

    return samomentum_kernel.velocity_accumulate(u, g, momentum=momentum,
                                                 lr=lr)


def samomentum_rescale(uacc, sent_mask, momentum: float, out=None):
    """Paper Alg. 3 line 11: sent coordinates keep their velocity, unsent
    are divided by m (as a multiply by the f32 reciprocal, the reference's
    rounding) so next step's ``m * u`` decay cancels.  Written into
    ``out`` when given."""
    return torch.where(sent_mask, uacc, uacc * rcp(momentum), out=out)


def support_mask(indices, size: int):
    """Boolean (size,) mask from a flat index set."""
    mask = torch.zeros(size, dtype=torch.bool, device=indices.device)
    mask[indices.to(torch.int64)] = True
    return mask


def rows_support_mask(idx, n: int):
    """Boolean (S, n) mask from per-row index sets (S, k)."""
    mask = torch.zeros((idx.shape[0], n), dtype=torch.bool,
                       device=idx.device)
    return mask.scatter_(1, idx.to(torch.int64), True)


def _maybe_quantize_rows(vals, mode: str):
    """The reference's quantization of a row-wise selection: ONE scale over
    all rows (its mesh exchange ships them as one message; one flat message
    is one row)."""
    if mode == "none":
        return vals
    vq, _ = quantize_dequantize(vals, mode)
    return vq.to(vals.dtype)


def select(x, k: int, spec: CompressionSpec = DEFAULT_SPEC) -> SparseLeaf:
    """Top-k of a flat tensor through the dispatched engine (+ wire
    quantization): :func:`select_rows` at S = 1."""
    flat = x.reshape(-1)
    vals, idx = select_rows(flat[None], k, spec)
    return SparseLeaf(values=vals[0], indices=idx[0], size=flat.shape[0])


def select_rows(x2d, k: int, spec: CompressionSpec = DEFAULT_SPEC):
    """Per-row top-k through the dispatched engine (+ wire quantization,
    one scale over all rows as the reference).  Returns (vals (S, k), idx
    (S, k) int32 local per-row)."""
    eng = resolve_engine(spec, int(x2d.shape[1]))
    vals, idx = eng.select_rows(x2d, k)
    return _maybe_quantize_rows(vals, spec.quantize), idx


def quantize_arena(msg: SparseLeaf, mode: str, seg) -> SparseLeaf:
    """Wire-quantize a global-index arena message SEGMENT-WISE (one scale
    per tensor, ``seg`` = per-tensor entry counts)."""
    if mode == "none":
        return msg
    return SparseLeaf(values=quantize_segments(msg.values, mode, seg),
                      indices=msg.indices, size=msg.size)


def _samomentum_select_rescale(u2d, g2d, eng, *, momentum: float, lr,
                               k: int, out=None):
    """Accumulate, select each row's support with ``eng``, rescale by the
    support mask (into ``out`` when given).  Returns (vals (S, k), idx
    (S, k) int32, u_new (S, n))."""
    uacc = velocity_accumulate(u2d, g2d, momentum=momentum, lr=lr)
    vals, idx = eng.select_rows(uacc, k)
    mask = rows_support_mask(idx, uacc.shape[1])
    return vals, idx, samomentum_rescale(uacc, mask, momentum, out=out)


def _row_fused(eng, u2d, g2d, k: int, lr) -> bool:
    """Whether the step of these rows is one pass of
    ``block_topk.samomentum_row_topk_rows``: the blockwise engine in its
    row regime, on float32 rows of unit stride, at one float ``lr``."""
    return isinstance(eng, BlockwiseEngine) \
        and not isinstance(lr, torch.Tensor) \
        and eng.row_regime(int(u2d.shape[1]), k) \
        and all(t.dtype == torch.float32 and (t.shape[1] == 1
                                              or t.stride(1) == 1)
                for t in (u2d, g2d))


def samomentum_step_rows(u2d, g2d, *, momentum: float, lr, k: int,
                         spec: CompressionSpec = DEFAULT_SPEC, out=None):
    """Row-wise SAMomentum step, as the reference's (its mesh hot path's
    ``(S, rest)`` view): accumulate, select, rescale by the support mask,
    then wire quantization with ONE scale over all rows, as
    :func:`select_rows`.  ``lr`` is a float or an ``(S, 1)`` tensor.  The
    new velocity is written into ``out`` when given (``u2d`` itself: in
    place).  Returns (vals (S, k), idx (S, k) int32, u_new (S, rest)).

    The blockwise engine's row regime at a float ``lr`` takes the whole
    step in one pass (``samomentum_row_topk_rows``: one launch for all
    rows, the same bits); any other row takes the chain of accumulate,
    select and rescale."""
    from repro_torch.kernels import block_topk

    eng = resolve_engine(spec, int(u2d.shape[1]))
    if _row_fused(eng, u2d, g2d, k, lr):
        vals, idx, u_new = block_topk.samomentum_row_topk_rows(
            u2d, g2d, momentum=momentum, lr=lr, k=k, out=out)
    else:
        vals, idx, u_new = _samomentum_select_rescale(
            u2d, g2d, eng, momentum=momentum, lr=lr, k=k, out=out)
    return _maybe_quantize_rows(vals, spec.quantize), idx, u_new


def _samomentum_leaf_rows(u2d, g2d, *, momentum: float, lr, k: int,
                          spec: CompressionSpec):
    """One SAMomentum step of each row of one tensor, in one pass over the
    ``(B, n)`` block; ``lr`` is a float or ``(B, 1)``.  Returns (vals
    (B, k), idx (B, k) int32, u_new (B, n)), the values before wire
    quantization."""
    eng = resolve_engine(spec, int(u2d.shape[1]))
    if isinstance(eng, BlockwiseEngine):
        return _samomentum_step_blockwise_rows(u2d, g2d, eng,
                                               momentum=momentum, lr=lr, k=k)
    return _samomentum_select_rescale(u2d, g2d, eng, momentum=momentum,
                                      lr=lr, k=k)


def _samomentum_step_blockwise_rows(u2d, g2d, eng: BlockwiseEngine, *,
                                    momentum, lr, k):
    """The kernel path, one launch of each kernel for all rows:

    1. ``eng.select_rows`` picks each row's support of the accumulated
       velocity (kernel 2's row regime for short rows under an exact plan,
       else its blocks over all rows and the candidate top-k),
    2. ``samomentum_fused_rows`` re-walks it once against each row's k-th
       candidate magnitude (kernel 3, one threshold per row), called as the
       reference calls it, on ``(uacc, uacc)`` with ``lr = 1 - m``
       (m*uacc + (1-m)*uacc, evaluated, not shortcut),
    3. ``scatter_add_rows`` repairs the coordinates that pass the threshold
       but are not shipped (ties, r < k): they are rescaled like any unsent
       one (kernel 4 on rows ``0..B-1`` of the step's own ``sent_dense``),
       and ``u_new + extra * (1/m - 1)`` is one fused multiply-add (the
       float32 ``fma`` kernel on the card).
    """
    from repro_torch.kernels import ops, samomentum_kernel

    uacc = velocity_accumulate(u2d, g2d, momentum=momentum, lr=lr)
    vals, idx = eng.select_rows(uacc, k)
    thr = vals.abs().amin(dim=1)
    sent_dense, u_new = ops.samomentum_fused_rows(
        uacc, uacc, thr, momentum=momentum, lr=1.0 - momentum)
    # extra = thresholded-but-not-shipped coordinates (0 on the support)
    extra = ops.scatter_add_rows(sent_dense, None, idx, -vals)
    return vals, idx, samomentum_kernel.fused_multiply_add(
        extra, 1.0 / momentum - 1.0, u_new)


def samomentum_step(u, g, *, momentum: float, lr: float, k: int,
                    spec: CompressionSpec = DEFAULT_SPEC):
    """One SAMomentum step on one tensor: accumulate -> select -> rescale,
    the row-wise step at B = 1.

    Returns (msg over the flattened tensor with ``spec.quantize`` applied,
    u_new shaped like ``u``; u_new never sees quantization error).
    """
    vals, idx, u_new = _samomentum_leaf_rows(
        u.reshape(1, -1), g.reshape(1, -1), momentum=momentum, lr=lr, k=k,
        spec=spec)
    vals = _maybe_quantize_rows(vals, spec.quantize)
    return (SparseLeaf(values=vals[0], indices=idx[0], size=u.numel()),
            u_new.reshape(u.shape))


def samomentum_step_arena_rows(u2d, g2d, space, *, momentum: float, lrs,
                               ks, spec: CompressionSpec = DEFAULT_SPEC):
    """SAMomentum over a ``(B, total)`` batch of velocity arenas with one
    learning rate per row (``lrs``, ``(B,)`` float32): per-tensor steps on
    the leaf views, one global-index message (indices rebased by leaf
    offset, each row's segment wire-quantized with its own scale) and one
    rescaled velocity arena.  The port's counterpart of the reference's
    ``vmap(strategy.step)``.  Each leaf's ``(B, n_leaf)`` view is strided
    (row stride ``total``); the velocity accumulate reads it and writes a
    contiguous block, which is what the kernels read.  Returns (SparseLeaf
    with ``(B, sum(ks))`` values/indices, the new ``(B, total)``
    velocity)."""
    lrs = lrs.reshape(-1, 1)
    vals, idxs, new_u = [], [], []
    for off, size, k in zip(space.offsets, space.sizes, ks):
        v, i, u_new = _samomentum_leaf_rows(
            u2d[:, off:off + size], g2d[:, off:off + size],
            momentum=momentum, lr=lrs, k=k, spec=spec)
        vals.append(quantize_rows(v, spec.quantize)[2].to(v.dtype))
        idxs.append(i + off)
        new_u.append(u_new)
    return (SparseLeaf(values=torch.cat(vals, dim=1),
                       indices=torch.cat(idxs, dim=1), size=space.total),
            torch.cat(new_u, dim=1))

