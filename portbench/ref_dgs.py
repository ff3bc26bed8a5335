"""Plain PyTorch reference of the DGS exchange that the benchmark's cells
run: W data-parallel workers, each with its SAMomentum velocity (paper
Eq. 11 and Alg. 3), a top-k of the velocity per row of each leaf, and
either

* ``allgather``: every worker's (values, indices) gathered and the union
  added into the update, divided by W; or
* ``shardedps`` (dual-way DGS): each selected entry bucketed to the
  worker that owns its column (W even column shards of every row), at
  most ``cap`` entries per (row, owner), the owner's accumulator M
  decreased by what it receives, and the top-``k2`` of each owner row of
  ``M - v`` sent back down, ``v`` increased by it (paper Eq. 6).

The parameters then lose the update.  Selection is exact (the
configuration's ``blockwise`` engine is exact at the cells' k, since it
keeps ``min(k, 1024)`` candidates a block).

How a leaf is cut into rows (the per-row thresholds of the exchange) is
this module's own frozen rule.  A leaf's *row dim* (of its core dims: a
stacked leaf, under ``units``, has a leading layer dim before them) is

* the output (last) dim of the query, key, value, gate, up,
  latent-expansion (``wq_b``, ``wkv_b``) and SSM input (``in_proj``)
  projections, weight and bias, and of the head (``lm_head``);
* the input (first) dim of the output, down and SSM output
  (``out_proj``) projections;
* the vocabulary of the embedding (``table``);
* the expert dim of a mixture-of-experts layer's expert tensors
  (``moe``'s ``gate``, ``up`` and ``down``, three core dims);
* the channel or head (last) dim of the SSM's per-channel and per-head
  leaves (``conv_w``, ``conv_b``, ``A_log``, ``dt_bias``, ``D``);

and every other leaf (norm scales and biases, the latent
down-projections ``wq_a`` and ``wkv_a``, the router) has none.  With a
row dim the rows are that dim's and the rest of the leaf in order their
columns.  Without one a leaf is one row; but ``allgather`` selects over
it whole only when it has fewer than 2**24 entries, and cuts a larger one
into rows of its first dim.  Where a row would hold more than 2**22
entries and more than one further dim is left, the leading further dims
fold into the rows, one at a time, as long as that holds.  Every leaf's k
is ``round(size * density)``, a row's ``ceil(k / rows)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# leaf owners whose row dim is the last (output) dim, and the first
_ROWS_LAST = {"wq", "wk", "wv", "gate", "up", "wq_b", "wkv_b", "lm_head",
              "in_proj"}
_ROWS_FIRST = {"wo", "down", "out_proj"}
# a mixture-of-experts layer's expert tensors, rows of the expert dim
_EXPERTS = {"gate", "up", "down"}
# the SSM's per-channel and per-head leaves, rows of their last dim
_CHANNELS = {"conv_w", "conv_b", "A_log", "dt_bias", "D"}
ROW_MAX = 1 << 22


def _core(path, shape) -> int:
    """The number of the leaf's core dims (a stacked leaf's layer dim
    left out)."""
    return len(shape) - (1 if path[0] == "units" else 0)


def is_expert(path, shape) -> bool:
    """Whether the leaf is a mixture-of-experts layer's routed expert
    tensor: ``moe``'s ``gate``, ``up`` or ``down``, with three core dims
    (experts first)."""
    return (path[-2] == "moe" and path[-1] in _EXPERTS
            and _core(path, shape) == 3)


def row_dim(path, shape):
    """The leaf's row dim (None: no row dim)."""
    stacked = path[0] == "units"
    core = _core(path, shape)
    owner, last = path[-2], path[-1]
    if last == "table":
        d = 0
    elif is_expert(path, shape):
        d = 0
    elif owner in _ROWS_LAST and last in ("w", "b"):
        d = core - 1
    elif owner in _ROWS_FIRST and last == "w":
        d = 0
    elif last in _CHANNELS:
        d = core - 1
    else:
        return None
    return d + (1 if stacked else 0)


def fold(shape, ax):
    """(S, rest): the rows of dim ``ax``, leading further dims folded
    into them while a row holds more than 2**22 entries and more than one
    further dim is left."""
    dims = list(shape)
    S = dims.pop(ax)
    while math.prod(dims) > ROW_MAX and len(dims) > 1:
        S *= dims.pop(0)
    return S, math.prod(dims)


def density_to_k(size: int, density: float) -> int:
    return max(1, min(size, int(round(size * density))))


class Cut(NamedTuple):
    """``S`` rows of ``rest`` with dim ``ax`` moved first (None: the leaf
    as one row), ``k_row`` per row; shardedps' owner columns
    ``shard_rest``, bucket ``cap`` and downward ``k2``."""

    S: int
    rest: int
    ax: int | None
    k_row: int
    shard_rest: int = 0
    cap: int = 0
    k2: int = 0


def cut(path, shape, mode: str, density: float, W: int,
        bucket_factor: float = 2.0) -> Cut:
    size = math.prod(shape)
    k = density_to_k(size, density)
    ax = row_dim(path, shape)
    whole = ax is None or len(shape) == 1
    if whole and mode == "allgather" and size >= 1 << 24:
        # too large to select over whole: rows of its first dim
        ax = 0
        S, rest = fold(shape, ax)
    elif whole:
        S, rest, ax = 1, size, None
    else:
        S, rest = fold(shape, ax)
    k_row = max(1, min(rest, -(-k // S)))
    if mode == "allgather":
        return Cut(S, rest, ax, k_row)
    shard_rest = -(-rest // W)
    cap = max(1, int(round(k_row / W * bucket_factor)))
    k2 = max(1, min(shard_rest, int(round(k_row / W))))
    return Cut(S, rest, ax, k_row, shard_rest, cap, k2)


def rows(x, c: Cut):
    """The leaf ``x`` as its (S, rest) rows (a copy)."""
    if c.ax is None:
        return x.reshape(1, -1).clone()
    return x.movedim(c.ax, 0).reshape(c.S, c.rest).clone()


def unrows(r, shape, c: Cut):
    """The inverse of :func:`rows`."""
    if c.ax is None:
        return r.reshape(shape)
    moved = (shape[c.ax],) + tuple(shape[:c.ax]) + tuple(shape[c.ax + 1:])
    return r.reshape(moved).movedim(0, c.ax)


class Worker:
    """One worker's exchange state for every leaf: velocity rows and, in
    shardedps, the M and v rows of the columns it owns."""

    def __init__(self):
        self.u, self.m, self.v = {}, {}, {}


def select(x2d, k):
    """Exact top-k |x| of each row, largest first, of equal magnitudes
    the lower index first: (values, indices)."""
    mag = x2d.abs()
    thr = torch.topk(mag, k, dim=1).values[:, -1:]
    above = mag > thr
    tied = mag == thr
    need = k - above.sum(1, keepdim=True)
    chosen = above | (tied & (torch.cumsum(tied, dim=1) <= need))
    idx = chosen.nonzero()[:, 1].reshape(x2d.shape[0], k)
    order = torch.sort(mag.gather(1, idx), dim=1, descending=True,
                       stable=True).indices
    idx = idx.gather(1, order)
    return x2d.gather(1, idx), idx


def accumulate(u, g, momentum, lr):
    """Paper Eq. 11: ``m * u + lr * g``, the product ``m * u`` and the sum
    rounded once to float32 (a fused multiply-add)."""
    m = float(np.float32(momentum))
    return (m * u.double() + (lr * g).double()).float()


def unsent(uacc, momentum):
    """Alg. 3 line 11's ``u / m`` as a multiply by the float32
    reciprocal."""
    return uacc * float(np.float32(1.0) / np.float32(momentum))


def worker_message(w: Worker, path, g2d, c: Cut, momentum, lr, mode):
    """One worker's upward step on one leaf: accumulate, select, rescale
    the unsent coordinates by ``1/m`` (Alg. 3 line 11).  Returns the
    shipped (values, indices): all of them in allgather, in shardedps the
    first ``cap`` of each (row, owner) bucket, in selection order, with
    ``-1`` for an index that is not shipped."""
    uacc = accumulate(w.u.get(path, torch.zeros_like(g2d)), g2d, momentum, lr)
    vals, idx = select(uacc, c.k_row)
    if mode == "shardedps":
        owner = idx // c.shard_rest
        order = torch.argsort(owner, dim=1, stable=True)
        owner_s = owner.gather(1, order)
        pos = torch.arange(c.k_row, device=g2d.device)[None] \
            - torch.searchsorted(owner_s, owner_s)
        keep = torch.empty_like(pos, dtype=torch.bool)
        keep.scatter_(1, order, pos < c.cap)
        idx = torch.where(keep, idx, -1)
    # an entry not shipped marks a spill column past the row's end
    shipped = torch.zeros((c.S, c.rest + 1), dtype=torch.bool,
                          device=g2d.device)
    shipped = shipped.scatter_(1, torch.where(idx >= 0, idx, c.rest),
                               True)[:, :-1]
    w.u[path] = torch.where(shipped, uacc, unsent(uacc, momentum))
    return vals, idx


def exchange_leaf(workers, path, grads, shape, c: Cut, mode, momentum, lr):
    """Every worker's step on one leaf (``grads``: the W workers' float32
    gradients of the leaf); returns the update the parameters lose."""
    W = len(workers)
    msgs = [worker_message(w, path, rows(g, c), c, momentum, lr, mode)
            for w, g in zip(workers, grads)]
    dev = grads[0].device
    if mode == "allgather":
        dense = torch.zeros((c.S, c.rest), dtype=torch.float32, device=dev)
        for vals, idx in msgs:
            dense.scatter_add_(1, idx, vals)
        return unrows(dense / W, shape, c)
    sr = c.shard_rest
    dense = torch.zeros((c.S, W * sr), dtype=torch.float32, device=dev)
    for o, owner in enumerate(workers):
        m = owner.m.get(path)
        if m is None:
            m = owner.m[path] = torch.zeros((c.S, sr), device=dev)
            owner.v[path] = torch.zeros((c.S, sr), device=dev)
        for vals, idx in msgs:
            mine = (idx >= o * sr) & (idx < (o + 1) * sr)
            m.scatter_add_(1, torch.where(mine, idx - o * sr, 0),
                           torch.where(mine, -vals, 0.0))
        d_vals, d_idx = select(m - owner.v[path], c.k2)
        owner.v[path].scatter_add_(1, d_idx, d_vals)
        dense.scatter_add_(1, d_idx + o * sr, d_vals)
    return unrows(-dense[:, :c.rest] / W, shape, c)


def velocity_norm(workers, path) -> float:
    """The norm of one leaf's velocity over all workers."""
    return math.sqrt(sum(float(w.u[path].double().square().sum())
                         for w in workers))
