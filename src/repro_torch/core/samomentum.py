"""Sparsification-Aware Momentum (SAMomentum) -- paper Eq. (11)/(12), Alg. 3
(PyTorch port of ``repro.core.samomentum``).

Per parameter tensor, each step:

    u      <- m * u_prev + eta * grad          (velocity accumulation)
    mask   <- top-k support of |u|
    g_sent <- u . mask                         (shipped, WITH lr)
    u      <- where(mask, u, u / m)            (Alg. 3 line 11)

Unsent coordinates are pre-divided by m so that next step's decay cancels
(Eq. 13); the velocity itself carries the unsent mass, so no residual
buffer exists.  The operator lives in ``core/engine.py``; this module is
its tree-shaped optimizer face.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import engine
from .engine import CompressionSpec
from .paramspace import ParamSpace, tree_leaves


class SAMomentumState(NamedTuple):
    velocity: torch.Tensor  # (total,) f32 velocity arena


def init(params) -> SAMomentumState:
    space = ParamSpace.from_tree(params)
    device = tree_leaves(params)[0].device
    return SAMomentumState(velocity=torch.zeros(
        space.total, dtype=torch.float32, device=device))


def leaf_update(u_prev, grad, *, momentum: float, lr: float, k: int,
                spec: CompressionSpec = engine.EXACT_SPEC):
    """Single-tensor SAMomentum step. Returns (msg: SparseLeaf, u_new)."""
    return engine.samomentum_step(
        u_prev, grad, momentum=momentum, lr=lr, k=k, spec=spec)


def leaf_update_dense(u_prev, grad, *, momentum, lr):
    """Density 1: every coordinate is sent each step, so SAMomentum is
    exactly heavy-ball momentum (paper Eq. 7/8)."""
    u = engine.velocity_accumulate(u_prev, grad, momentum=momentum, lr=lr)
    return u, u


def tree_update_rows(state: SAMomentumState, g2d, space: ParamSpace, *,
                     momentum: float, lrs, density: float,
                     spec: CompressionSpec = engine.EXACT_SPEC):
    """SAMomentum over a batch of packed gradient arenas: per-tensor
    selection on arena views, one velocity buffer per row, one global-index
    message per row.  ``state.velocity`` and ``g2d`` are ``(B, total)``,
    ``lrs`` one float32 learning rate per row (B = 1 for one worker's
    step).  Returns (msg with ``(B, k)`` values/indices, new_state)."""
    msg, u_new = engine.samomentum_step_arena_rows(
        state.velocity, g2d, space, momentum=momentum, lrs=lrs,
        ks=space.ks(density), spec=spec)
    return msg, SAMomentumState(velocity=u_new)
