"""Frozen counts: the card's published peaks, a train step's model FLOPs
and the exchange's least bytes, each worked out from the configuration's
shapes and the cell's traffic, never from what the program ran.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full 700 W power limit: 989 TFLOP/s in bf16, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

import math
from fractions import Fraction

from . import ref_dgs

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def _matrix_macs_per_token(cfg, layout):
    """Multiply-adds a token spends in the model's projections: every
    ``matrix`` leaf (the embedding, a lookup, is not one), a stacked leaf
    once per layer.  A routed expert tensor (:func:`ref_dgs.is_expert`,
    as ``moe/up``) counts ``top_k / E_router`` of its size: a token visits
    ``top_k`` (the configuration's ``moe.top_k``) of the ``E_router``
    experts that the router beside it (``moe/router/w``) scores, its
    output width, and the leaf holds those of them that are here.  The
    router and shared-expert leaves are plain matrices."""
    shapes = {path: shape for path, shape, _ in layout}
    macs = 0
    for path, shape, init in layout:
        if init != "matrix":
            continue
        size = math.prod(shape)
        if ref_dgs.is_expert(path, shape):
            e_router = shapes[path[:-1] + ("router", "w")][-1]
            size = Fraction(size * cfg["moe"]["top_k"], e_router)
        macs += size
    return macs


def _attention_macs_per_sequence(cfg, seq: int) -> int:
    """Multiply-adds of the scores and the value product of one causal
    sequence over all layers: every query against itself and the keys
    before it."""
    pairs = seq * (seq + 1) // 2
    if cfg.get("mla"):
        m = cfg["mla"]
        per_head = m["qk_nope_head_dim"] + m["qk_rope_head_dim"] + m["v_head_dim"]
    else:
        per_head = 2 * cfg["head_dim"]
    return cfg["n_layers"] * cfg["n_heads"] * per_head * pairs


def train_step_flops(cfg, layout, traffic) -> float:
    """A train step's model FLOPs: the forward's products (2 FLOPs a
    multiply-add) and the backward's (twice the forward's), over the
    global batch; no recompute; a routed expert's products for the
    tokens routed to it alone (:func:`_matrix_macs_per_token`)."""
    batch, seq = traffic["batch"], traffic["seq"]
    macs = (_matrix_macs_per_token(cfg, layout) * batch * seq
            + _attention_macs_per_sequence(cfg, seq) * batch)
    flops = 3 * 2 * macs
    return int(flops) if flops.denominator == 1 else float(flops)


def exchange_least_bytes(layout, traffic) -> int:
    """The least bytes a step's exchange moves through device memory,
    over all W workers: each worker's gradient and velocity read once,
    its velocity written once; its selected entries (value and index, 8
    bytes) written once and read once; in shardedps each owner's M and v
    read and written once, every bucket slot and each owner's downward
    entries written and read once; the update written once."""
    W, mode = traffic["workers"], traffic["mode"]
    total = 0
    for path, shape, _ in layout:
        size = math.prod(shape)
        c = ref_dgs.cut(path, shape, mode, traffic["density"], W,
                        traffic.get("bucket_factor", 2.0))
        total += W * 3 * 4 * size + 4 * size
        if mode == "allgather":
            total += W * c.S * c.k_row * 8 * 2
        else:
            total += 2 * 2 * 4 * c.S * c.shard_rest * W
            total += W * c.S * (W * c.cap + c.k2) * 8 * 2
    return total
