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


# ---------------------------------------------------------------------------
# shard routing: the placement half of the mesh server's route exchange
# ---------------------------------------------------------------------------

def route_by_shard(indices, values, *, bounds, n_shards: int, cap: int):
    """Bucket one global-index sparse message into per-shard slots:
    :func:`route_by_shard_batch` of one chunk.  Returns ``(local_idx, vals,
    overflow)`` shaped ``(S, cap)``, ``(S, cap)`` and a scalar."""
    ri, rv, ovf = route_by_shard_batch(indices[None], values[None],
                                       bounds=bounds, n_shards=n_shards,
                                       cap=cap)
    return ri[0], rv[0], ovf


def route_slots(indices, values, *, bounds, n_shards: int, cap: int):
    """The slot math of :func:`route_by_shard_batch`, in torch library ops:
    ``(slots, placed, local_idx, overflow)``, ``slots`` the ``(N * k,)``
    int32 positions of the entries in the flat ``(N * (S*cap + 1),)``
    buffer, ``placed`` their f32 values (0 for a dropped entry, which goes
    to its chunk's dump slot), ``local_idx`` the ``(N, S, cap)`` int32
    shard-local indices and ``overflow`` the int64 count of real entries
    over ``cap``.

    Ownership is ``searchsorted(bounds, i, right) - 1`` (an empty shard's
    duplicate bound resolves to the shard that is not empty), padding
    (``-1``) goes to the virtual shard S and is dropped, and a stable
    argsort keeps each shard's entries in message order; an entry's slot in
    its shard is its rank there, found by a batched ``searchsorted`` of each
    sorted row on itself."""
    S, cap = int(n_shards), int(cap)
    n, k = indices.shape
    device = indices.device
    bnd = torch.as_tensor(bounds, dtype=torch.int64, device=device)
    idx = indices.to(torch.int64)
    owner = torch.where(idx < 0, S,
                        torch.searchsorted(bnd, idx, right=True) - 1)
    order = torch.argsort(owner, dim=1, stable=True)
    o_s = torch.gather(owner, 1, order)
    i_s = torch.gather(idx, 1, order)
    v_s = torch.gather(values, 1, order).to(torch.float32)
    rank = (torch.arange(k, device=device)[None, :]
            - torch.searchsorted(o_s, o_s))
    real = o_s < S
    ok = (rank < cap) & real
    row_len = S * cap + 1
    slot = torch.where(ok, o_s * cap + rank, S * cap)
    slots = (slot + torch.arange(n, device=device)[:, None] * row_len
             ).reshape(-1)
    ri = torch.full((n * row_len,), -1, dtype=torch.int32, device=device)
    ri[slots] = torch.where(ok, i_s - bnd[o_s.clamp(0, S - 1)], -1).to(
        torch.int32).reshape(-1)
    ri = ri.view(n, row_len)[:, :-1].reshape(n, S, cap)
    return (slots.to(torch.int32), torch.where(ok, v_s, 0.0).reshape(-1),
            ri, (real & (rank >= cap)).sum())


def route_by_shard_batch(indices, values, *, bounds, n_shards: int,
                         cap: int):
    """Bucket ``(N, k)`` chunks of global-index sparse messages into
    per-shard slots (:func:`route_slots`), the values placed by ONE flat
    scatter-add (kernel 1 on a card) into a zeroed ``(N * (S*cap + 1),)``
    buffer: every chunk's slots are offset by ``chunk * (S*cap + 1)``, one
    dump slot per chunk.  The values are ADDED into zeros, so a routed
    ``-0.0`` comes out ``+0.0``, as in the reference, whose placement is
    its scatter-add too.

    ``indices`` are int32 global arena indices (``-1`` marks padding),
    ``bounds`` the ``(S+1,)`` ascending ``ShardSpec.bounds``.  Returns
    ``(local_idx, vals, overflow)``: ``(N, S, cap)`` shard-LOCAL int32
    indices (``-1`` = empty slot), ``(N, S, cap)`` f32 values (0 in empty
    slots) and an int64 scalar on the device, the real entries dropped
    because their shard already held ``cap``.
    """
    S, cap = int(n_shards), int(cap)
    n = indices.shape[0]
    slots, placed, ri, overflow = route_slots(
        indices, values, bounds=bounds, n_shards=S, cap=cap)
    rv = torch.zeros(n * (S * cap + 1), dtype=torch.float32,
                     device=indices.device)
    scatter_add(rv, slots, placed)
    rv = rv.view(n, S * cap + 1)[:, :-1].reshape(n, S, cap)
    return ri, rv, overflow
