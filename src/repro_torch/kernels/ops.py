"""Public wrappers around the kernels (port of ``repro.kernels.ops``):
shapes, padding and the candidate combine.  This is what the rest of the
port calls.

The TPU's ``_bucket_blocked`` layout has no counterpart: the scatter kernel
writes only its target words.  Where the reference's functions return a new
array, :func:`scatter_add` and :func:`scatter_add_row` update their first
argument IN PLACE (the reference donates those buffers) and return it.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparsify import topk_indices

from .block_topk import BLOCK, GROUP, block_topk_2d
from .samomentum_kernel import samomentum_fused_flat
from .scatter_apply import scatter_add_


def samomentum_fused(u, g, thr, *, momentum: float, lr: float):
    """Fused SAMomentum over an arbitrary-shape tensor.

    Returns (sent_dense, u_new): the thresholded velocity in dense layout
    (zeros where unsent) and the rescaled velocity.
    """
    shape = u.shape
    thr = torch.as_tensor(thr, dtype=torch.float32,
                          device=u.device).reshape(1)
    out, u_new = samomentum_fused_flat(
        u.reshape(-1).contiguous(),
        g.to(u.dtype).reshape(-1).contiguous(), thr,
        momentum=momentum, lr=lr)
    return out.reshape(shape), u_new.reshape(shape)


def block_topk_candidates(x, *, r: int):
    """Per-block top-r winners of |x|.  Returns (vals, global_idx), each
    (nb, r).  The input is zero-padded to whole groups of ``GROUP`` blocks,
    as the reference pads it, so both return the same candidates (and the
    same count of them, which shows when k exceeds the real ones); padding
    elements (index >= x.numel()) can win only against zeros."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % (BLOCK * GROUP)
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    x2d = flat.reshape(-1, BLOCK)
    vals, idx = block_topk_2d(x2d, r=r)
    offs = torch.arange(x2d.shape[0], dtype=torch.int32,
                        device=x.device) * BLOCK
    return vals, idx + offs[:, None]


def hierarchical_topk(x, *, k: int, r: int | None = None):
    """Top-k |x| via block winners + a candidate top-k.

    Exact iff r >= k.  The candidate top-k is a library sort, as
    ``lax.top_k`` is in the reference: padding ranks at -1, ties go to the
    lower candidate position.  Returns (values, indices) into flattened x.
    """
    r = min(k if r is None else r, BLOCK)
    vals, gidx = block_topk_candidates(x, r=r)
    cvals = vals.reshape(-1)
    cidx = gidx.reshape(-1)
    mag = torch.where(cidx < x.numel(), cvals.abs(), -1.0)
    sel = topk_indices(mag, min(k, cvals.shape[0]))
    return cvals[sel], cidx[sel]


def scatter_add(dense, indices, values):
    """``dense[indices] += values`` in place on a flat arena (server
    receive, worker apply, blockwise support repair); returns ``dense``."""
    return scatter_add_(dense, indices, values.to(dense.dtype))


def scatter_add_row(dense2d, row: int, indices, values):
    """``dense2d[row, indices] += values`` in place -- one worker row of the
    server's ``v`` (a contiguous view); returns ``dense2d``."""
    scatter_add_(dense2d[row], indices, values.to(dense2d.dtype))
    return dense2d
