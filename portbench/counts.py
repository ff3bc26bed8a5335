"""Frozen counts: the card's published peaks, a train step's model FLOPs
and the exchange's least bytes, each worked out from the configuration's
shapes and the cell's traffic, never from what the program ran.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full 700 W power limit: 989 TFLOP/s in bf16, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

import math

from . import ref_dgs

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def _matrix_macs_per_token(layout) -> int:
    """Multiply-adds a token spends in the model's projections: every
    ``matrix`` leaf (the embedding, a lookup, is not one), a stacked leaf
    once per layer."""
    return sum(math.prod(shape) for _, shape, init in layout
               if init == "matrix")


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
    global batch; no recompute."""
    batch, seq = traffic["batch"], traffic["seq"]
    macs = (_matrix_macs_per_token(layout) * batch * seq
            + _attention_macs_per_sequence(cfg, seq) * batch)
    return 3 * 2 * macs


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
