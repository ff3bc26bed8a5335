"""The mesh server's route exchange (PyTorch port of
``repro.core.distributed.shard_exchange_batch``; the dense, allgather and
shardedps exchanges of that module are not ported yet).

On the TPU the reference cuts every message into S source chunks, one per
device of a ``shards`` mesh axis, routes each chunk to per-destination
buckets and swaps the buckets with one all-to-all.  The port keeps all S
shard arenas on one card, so it routes every chunk there and applies the
same ``(source, destination)`` permutation, the reference's own leg for
one device (pinned bit-equal to its collective in the reference's tests).
"""
from __future__ import annotations

import torch

from .paramspace import ShardSpec


def shard_exchange_batch(spec: ShardSpec, indices, values, *,
                         cap: int | None = None, use_mesh: bool | None = None):
    """Route a batch of global-index sparse messages to shard-local slots.

    ``indices``/``values``: ``(B, k)``, int32 global arena indices (``-1``
    = padding).  Each message is cut into ``S`` even source chunks of
    ``kp = ShardSpec.even_stride(k, S)``, every chunk is bucketed by
    ``kernels.ops.route_by_shard_batch`` (one scatter-add for all ``B * S``
    chunks), and the buckets are permuted ``(src, dst) -> (dst, src)``.

    ``cap`` bounds the entries per (source chunk, destination shard) pair
    and defaults to ``kp``: a chunk holds only ``kp`` entries, so the
    default never overflows.

    Returns ``(local_idx, vals, overflow)``: ``(B, S, S*cap)`` shard-local
    indices (``-1`` = empty slot) and values, and the int64 count of
    entries dropped by ``cap`` (a scalar on the device).  ``use_mesh=True``
    (one process per shard, over ``torch.distributed``) raises.
    """
    from repro_torch.kernels import ops

    if use_mesh:
        raise NotImplementedError(
            "the multi-device leg of shard_exchange_batch (one process per "
            "shard, over torch.distributed.all_to_all_single) comes with "
            "the dense, allgather and shardedps exchanges (ROADMAP queue 1 "
            "item 4); every shard arena of the port's mesh server lives on "
            "one card")
    S = spec.n_shards
    B, k = indices.shape
    kp = ShardSpec.even_stride(k, S)
    cap = int(cap) if cap is not None else kp
    pad = S * kp - k
    idx3 = torch.nn.functional.pad(indices.to(torch.int32), (0, pad),
                                   value=-1).reshape(B * S, kp)
    val3 = torch.nn.functional.pad(values, (0, pad)).reshape(B * S, kp)
    ri, rv, ovf = ops.route_by_shard_batch(idx3, val3, bounds=spec.bounds,
                                           n_shards=S, cap=cap)
    ri = ri.view(B, S, S, cap).transpose(1, 2).reshape(B, S, S * cap)
    rv = rv.view(B, S, S, cap).transpose(1, 2).reshape(B, S, S * cap)
    return ri, rv, ovf
