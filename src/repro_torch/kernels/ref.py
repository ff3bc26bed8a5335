"""Plain-tensor oracles for the kernels (port of ``repro.kernels.ref``).

Like the reference's, these run op by op, one rounding per operator
(the reference evaluates them eagerly, outside ``jit``); the kernels follow
the fused forms of ``repro_torch.arith`` and agree with these to an ulp.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparsify import topk_indices


def samomentum_ref(u, g, thr, *, momentum: float, lr: float):
    """Returns (out, u_new, sent); see ``samomentum_kernel``."""
    uacc = momentum * u.to(torch.float32) + lr * g.to(torch.float32)
    sent = uacc.abs() >= thr
    out = torch.where(sent, uacc, torch.zeros_like(uacc))
    m = torch.full((), momentum, dtype=torch.float32, device=uacc.device)
    u_new = torch.where(sent, uacc, uacc / m)
    return out.to(u.dtype), u_new.to(u.dtype), sent


def block_topk_ref(x, *, block: int, r: int):
    """Per-block top-r of |x| over a zero-padded ``(nb, block)`` view.
    Returns (values (nb, r), indices (nb, r) GLOBAL into the flat input)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    nb = -(-n // block)
    vals = torch.nn.functional.pad(flat, (0, nb * block - n)).reshape(nb, block)
    idx = topk_indices(vals.abs(), r)
    winners = torch.gather(vals, 1, idx)
    gidx = idx + torch.arange(nb, device=x.device)[:, None] * block
    return winners, gidx.to(torch.int32)


def scatter_accumulate_ref(dense, indices, values):
    """A copy of ``dense`` with ``values`` added at ``indices``, duplicates
    accumulated (in update order on the CPU)."""
    return dense.clone().index_put_((indices.to(torch.int64),),
                                    values.to(dense.dtype), accumulate=True)
