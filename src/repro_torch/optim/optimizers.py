"""Optimizers over the port's parameter trees (nested dicts of tensors)
and learning-rate schedules (PyTorch port of ``repro.optim.optimizers``).

The DGS path does not use these for the exchanged update (SAMomentum *is*
the optimizer there, ``core/samomentum.py``); they serve the baselines,
the single-node MSGD reference and the dense training path.  Every update
returns new trees on the trees' device and leaves its inputs alone.

The reference's float32 ``m * u + g`` and ``p - lr * u`` compile to one
fused multiply-add each; here they go through
``samomentum_kernel.fused_multiply_add`` (the float32 kernel on the card,
``arith.fma`` on the CPU), so momentum and SGD give the reference's bits.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.paramspace import tree_flatten, tree_unflatten
from repro_torch.kernels.samomentum_kernel import fused_multiply_add


def _map(fn, *trees):
    """``fn`` over the trees' leaves, in the first tree's structure."""
    leaves, paths = tree_flatten(trees[0])
    rest = [tree_flatten(t)[0] for t in trees[1:]]
    return tree_unflatten(paths, [fn(*xs) for xs in zip(leaves, *rest)])


def _descend(p, lr: float, u):
    """``p - lr * u`` as ``fma(-lr, u, p)`` in float32, cast to ``p``'s
    dtype."""
    return fused_multiply_add(-lr, u.to(torch.float32),
                              p.to(torch.float32)).to(p.dtype)


class MomentumState(NamedTuple):
    velocity: object


def momentum_init(params) -> MomentumState:
    return MomentumState(velocity=_map(torch.zeros_like, params))


def momentum_update(params, grads, state: MomentumState, *, lr: float,
                    momentum: float = 0.9, nesterov: bool = False):
    """``v = m * v + g``; the step is ``v``, or ``g + m * v`` (Nesterov);
    ``p - lr * step``.  Velocities and gradients are float32, as the
    port's parameters.  Returns (params, state)."""
    v = _map(lambda u, g: fused_multiply_add(momentum, u, g),
             state.velocity, grads)
    if nesterov:
        upd = _map(lambda g, u: fused_multiply_add(momentum, u, g), grads,
                   v)
    else:
        upd = v
    new_params = _map(lambda p, u: _descend(p, lr, u), params, upd)
    return new_params, MomentumState(velocity=v)


def sgd_update(params, grads, *, lr: float):
    return _map(lambda p, g: _descend(p, lr, g), params, grads)


class AdamWState(NamedTuple):
    mu: object
    nu: object
    count: int


def adamw_init(params) -> AdamWState:
    z = _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return AdamWState(mu=z, nu=z, count=0)


def adamw_update(params, grads, state: AdamWState, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0):
    """AdamW with float32 moments and bias correction; the decoupled
    weight decay adds ``weight_decay * p`` to the step.  Returns (params,
    state)."""
    c = state.count + 1
    mu = _map(lambda m, g: fused_multiply_add(
        b1, m, (1 - b1) * g.to(torch.float32)), state.mu, grads)
    nu = _map(lambda n, g: fused_multiply_add(
        b2, n, (1 - b2) * torch.square(g.to(torch.float32))), state.nu, grads)
    # the bias corrections in float32, as the reference's
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(c))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(c))

    def upd(p, m, n):
        p32 = p.to(torch.float32)
        step = (m / bc1) / (torch.sqrt(n / bc2) + eps)
        if weight_decay:
            step = fused_multiply_add(weight_decay, p32, step)
        return fused_multiply_add(-lr, step, p32).to(p.dtype)

    new_params = _map(upd, params, mu, nu)
    return new_params, AdamWState(mu=mu, nu=nu, count=c)


def step_decay_lr(base_lr: float, *, boundaries=(0.6, 0.8), factor=0.1,
                  total_steps: int = 100):
    """The paper's schedule: decay by 0.1 at epoch 30 and 40 of 50."""
    bs = [int(b * total_steps) for b in boundaries]

    def lr_fn(step: int) -> float:
        lr = base_lr
        for b in bs:
            if step >= b:
                lr *= factor
        return lr

    return lr_fn


def cosine_lr(base_lr: float, *, warmup: int = 100, total_steps: int = 1000,
              min_frac: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine from
    ``base_lr`` down to ``min_frac * base_lr`` at ``total_steps``."""
    def lr_fn(step: int) -> float:
        if step < warmup:
            return base_lr * (step + 1) / warmup
        t = (step - warmup) / max(1, total_steps - warmup)
        t = min(1.0, t)
        return base_lr * (min_frac + (1 - min_frac) * 0.5 *
                          (1 + math.cos(math.pi * t)))

    return lr_fn
