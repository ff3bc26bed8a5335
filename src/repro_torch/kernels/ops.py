"""Public wrappers around the kernels (port of ``repro.kernels.ops``):
shapes, padding and the candidate combine.  This is what the rest of the
port calls.

The TPU's ``_bucket_blocked`` layout has no counterpart: the scatter kernels
write only their target words.  Where the reference's functions return a new
array, :func:`scatter_add`, :func:`scatter_add_row` and
:func:`scatter_add_rows` update their first argument IN PLACE (the reference
donates those buffers) and return it.

Each row-wise wrapper (``*_rows``) is the counterpart of the reference's
``vmap`` of the flat one: it launches its kernel ONCE for the whole batch,
and the flat wrapper is the row-wise one at B = 1 wherever that is the same
computation, so the serial and the batched loop share one code path.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparsify import topk_indices

from .block_topk import BLOCK, GROUP, block_topk_2d
from .samomentum_kernel import samomentum_fused_flat
from .scatter_apply import scatter_add_, scatter_add_rows_


def samomentum_fused(u, g, thr, *, momentum: float, lr: float):
    """Fused SAMomentum over an arbitrary-shape tensor: the row-wise call
    at B = 1.

    Returns (sent_dense, u_new): the thresholded velocity in dense layout
    (zeros where unsent) and the rescaled velocity.
    """
    thr = torch.as_tensor(thr, dtype=torch.float32, device=u.device)
    out, u_new = samomentum_fused_rows(u.reshape(1, -1), g.reshape(1, -1),
                                       thr.reshape(1), momentum=momentum,
                                       lr=lr)
    return out.reshape(u.shape), u_new.reshape(u.shape)


def samomentum_fused_rows(u2d, g2d, thr, *, momentum: float, lr: float):
    """Row-wise :func:`samomentum_fused`: ``(B, n)`` operands and ``(B,)``
    thresholds, one per row, in ONE launch.  Returns (sent_dense, u_new),
    each ``(B, n)``."""
    shape = u2d.shape
    out, u_new = samomentum_fused_flat(
        u2d.contiguous().view(-1), g2d.to(u2d.dtype).contiguous().view(-1),
        thr.to(torch.float32).reshape(shape[0]).contiguous(),
        momentum=momentum, lr=lr)
    return out.view(shape), u_new.view(shape)


def block_topk_candidates_rows(x2d, *, r: int):
    """Per-block top-r winners of |x| for each row of ``(B, n)``.  Returns
    (vals, idx), each ``(B, nb, r)``, idx per-row.  Each row is zero-padded
    to whole groups of ``GROUP`` blocks ON ITS OWN, as the reference's vmap
    pads each row, and all B * nb blocks go through ONE kernel launch."""
    B, n = x2d.shape
    pad = (-n) % (BLOCK * GROUP)
    if pad:
        x2d = torch.nn.functional.pad(x2d, (0, pad))
    nb = x2d.shape[1] // BLOCK
    vals, idx = block_topk_2d(x2d.contiguous().view(B * nb, BLOCK), r=r)
    offs = torch.arange(nb, dtype=torch.int32, device=x2d.device) * BLOCK
    return vals.view(B, nb, r), idx.view(B, nb, r) + offs[None, :, None]


def block_topk_candidates(x, *, r: int):
    """Per-block top-r winners of |x|.  Returns (vals, global_idx), each
    (nb, r).  The input is zero-padded to whole groups of ``GROUP`` blocks,
    as the reference pads it, so both return the same candidates (and the
    same count of them, which shows when k exceeds the real ones); padding
    elements (index >= x.numel()) can win only against zeros."""
    vals, idx = block_topk_candidates_rows(x.reshape(1, -1), r=r)
    return vals[0], idx[0]


def hierarchical_topk_rows(x2d, *, k: int, r: int | None = None):
    """Row-wise top-k |x| via block winners + a candidate top-k: ONE block
    top-r launch for every row, then one stable descending sort per row of
    its candidates (padding ranks at -1, ties to the lower candidate
    position, as ``lax.top_k``).  Exact iff r >= k.  Returns (values,
    indices), each ``(B, min(k, candidates))``, indices per-row."""
    B, n = x2d.shape
    r = min(k if r is None else r, BLOCK)
    vals, gidx = block_topk_candidates_rows(x2d, r=r)
    cvals = vals.reshape(B, -1)
    cidx = gidx.reshape(B, -1)
    mag = torch.where(cidx < n, cvals.abs(), -1.0)
    sel = topk_indices(mag, min(k, cvals.shape[1]))
    return torch.gather(cvals, 1, sel), torch.gather(cidx, 1, sel)


def hierarchical_topk(x, *, k: int, r: int | None = None):
    """Top-k |x| via block winners + a candidate top-k: the row-wise
    function at B = 1.  Returns (values, indices) into flattened x."""
    vals, idx = hierarchical_topk_rows(x.reshape(1, -1), k=k, r=r)
    return vals[0], idx[0]


def scatter_add(dense, indices, values):
    """``dense[indices] += values`` in place on a flat arena (server
    receive, worker apply, blockwise support repair); returns ``dense``."""
    return scatter_add_(dense, indices, values.to(dense.dtype))


def scatter_add_row(dense2d, row, indices, values):
    """``dense2d[row, indices] += values`` in place -- one worker row of the
    server's ``v``: :func:`scatter_add_rows` at B = 1, ``row`` a host int
    or a one-element int64 tensor on ``dense2d``'s device (the scan
    runner's worker id); returns ``dense2d``."""
    rows = row.reshape(1) if isinstance(row, torch.Tensor) else (int(row),)
    return scatter_add_rows(dense2d, rows, indices[None], values[None])


def scatter_add_rows(dense2d, rows, idx2d, vals2d):
    """Batched multi-row scatter-add, in place: ``dense2d[rows[b],
    idx2d[b]] += vals2d[b]`` for every lane b, ONE launch of kernel 4.
    ``rows`` is a host sequence of pairwise-distinct row ids (the batching
    rule), ``None`` for the rows ``0..B-1``, or their int64 tensor on the
    device; returns ``dense2d``."""
    return scatter_add_rows_(dense2d, rows, idx2d.contiguous(),
                             vals2d.to(dense2d.dtype).contiguous())
