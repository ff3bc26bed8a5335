"""Worker-side update strategies: DGS (ours) and the paper's baselines
(PyTorch port of ``repro.core.baselines``).

A strategy owns the worker-side state and the upward message:

    init(params)                      -> state (arena tensors)
    step_rows(state, g2d, lrs, space) -> (state', msg)
    step(state, grads, lr)            -> (state', msg)

``step_rows`` steps a batch of workers at once, the port's counterpart of
the reference's ``vmap(strategy.step)``: every state tensor and the packed
grads ``g2d`` are stacked ``(B, total)``, ``lrs`` holds one float32
learning rate per row, and ``msg`` is a global-index SparseLeaf with
``(B, k)`` values/indices over the packed arena (sparse strategies,
per-tensor top-k through ``core/engine.py``) or a dense ``(B, total)``
stack (ASGD); it always includes the learning rate.  ``step`` is one
worker's step, ``step_rows`` at B = 1, so the serial and the batched event
loop run one code path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.kernels.samomentum_kernel import fused_multiply_add

from . import engine as engine_lib
from . import samomentum
from .engine import CompressionSpec
from .paramspace import ParamSpace, tree_flatten, tree_unflatten
from .sparsify import SparseLeaf


class StrategyState(NamedTuple):
    inner: Any  # strategy-specific arena tensors


def state_tensors(state) -> list:
    """The tensors of a strategy state (nested NamedTuples), in order."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, tuple):
        return [t for part in state for t in state_tensors(part)]
    return []


def state_map(fn, state):
    """The strategy state with ``fn`` applied to each of its tensors."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    if isinstance(state, tuple):
        parts = [state_map(fn, part) for part in state]
        return type(state)(*parts) if hasattr(state, "_fields") \
            else tuple(parts)
    return state


def _zeros(params) -> torch.Tensor:
    space = ParamSpace.from_tree(params)
    device = tree_flatten(params)[0][0].device
    return torch.zeros(space.total, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str = "base"
    sparse: bool = False
    engine: str = "exact"
    quantize: str = "none"

    @property
    def spec(self) -> CompressionSpec:
        """The compression-engine spec this strategy selects with."""
        return CompressionSpec(engine=self.engine, quantize=self.quantize)

    @property
    def value_bits(self) -> int:
        return self.spec.value_bits

    def message_seg(self, space: ParamSpace) -> tuple[int, ...] | None:
        """Per-tensor entry counts of the upward message (the arena wire
        frame's segmentation), or None for dense messages."""
        return None

    def init(self, params) -> StrategyState:
        raise NotImplementedError

    def step_rows(self, state: StrategyState, g2d: torch.Tensor,
                  lrs: torch.Tensor, space: ParamSpace):
        raise NotImplementedError

    def step(self, state: StrategyState, grads, lr: float):
        """One worker's step on a gradient tree: :meth:`step_rows` at
        B = 1.  Returns (new state, msg over the ``(total,)`` arena)."""
        space = ParamSpace.from_tree(grads)
        g = space.pack(grads)
        lrs = torch.full((1,), lr, dtype=torch.float32, device=g.device)
        state, msg = self.step_rows(state_map(lambda t: t[None], state),
                                    g[None], lrs, space)
        msg = msg.row(0) if isinstance(msg, SparseLeaf) else msg[0]
        return state_map(lambda t: t[0], state), msg


@dataclasses.dataclass(frozen=True)
class _SparseStrategy(Strategy):
    """Shared plumbing for density-parameterized sparse strategies."""

    sparse: bool = True
    density: float = 0.01

    def message_seg(self, space: ParamSpace) -> tuple[int, ...]:
        return space.ks(self.density)


@dataclasses.dataclass(frozen=True)
class ASGD(Strategy):
    """Vanilla asynchronous SGD: dense eta*grad upward."""

    name: str = "asgd"
    sparse: bool = False

    def init(self, params):
        return StrategyState(inner=())

    def step_rows(self, state, g2d, lrs, space):
        return state, lrs.reshape(-1, 1) * g2d


@dataclasses.dataclass(frozen=True)
class GDAsync(_SparseStrategy):
    """Gradient Dropping (Aji & Heafield 2017), async port: residual
    accumulation of lr-scaled gradients; per-tensor top-k of the residual
    is sent, the remainder stays local."""

    name: str = "gd_async"

    def init(self, params):
        return StrategyState(inner=_zeros(params))

    def step_rows(self, state, g2d, lrs, space):
        # r + lr * g, fused
        r = fused_multiply_add(lrs.reshape(-1, 1), g2d, state.inner)
        msg = space.select_rows(r, space.ks(self.density), self.spec)
        # r is this step's own tensor, so it is zeroed in place
        r.scatter_(1, msg.indices.to(torch.int64), 0.0)
        return StrategyState(inner=r), msg


class _DGCState(NamedTuple):
    velocity: torch.Tensor   # momentum-corrected velocity arena
    residual: torch.Tensor   # accumulated unsent velocity arena


@dataclasses.dataclass(frozen=True)
class DGCAsync(_SparseStrategy):
    """Deep Gradient Compression (Lin et al. 2017), async port: velocity
    u = m*u + lr*g accumulates into a residual r += u; per-tensor top-k of
    r is sent; both u and r are zeroed on the sent coordinates."""

    name: str = "dgc_async"
    momentum: float = 0.7
    clip_norm: float | None = None

    def init(self, params):
        return StrategyState(inner=_DGCState(velocity=_zeros(params),
                                             residual=_zeros(params)))

    def step_rows(self, state, g2d, lrs, space):
        g = g2d
        if self.clip_norm is not None:
            # each row's norm is the reference's sum of leaf sums
            gnorm = torch.stack([
                torch.sqrt(sum(torch.sum(v ** 2) for v in space.views(row)))
                for row in g])
            g = g * torch.clamp(self.clip_norm / (gnorm + 1e-12),
                                max=1.0)[:, None]
        # u = m*u + lr*g.  XLA picks per program which product it fuses:
        # the reference's serial DGC step fuses lr*g, fma(lr, g, m*u) (its
        # batched step does not -- the reference's own 1-ulp serial/batched
        # disagreement), so the port follows the serial step
        u = fused_multiply_add(lrs.reshape(-1, 1), g,
                               self.momentum * state.inner.velocity)
        r = state.inner.residual + u
        msg = space.select_rows(r, space.ks(self.density), self.spec)
        sent = msg.indices.to(torch.int64)
        # momentum factor masking; u and r are this step's own tensors
        u.scatter_(1, sent, 0.0)
        r.scatter_(1, sent, 0.0)
        return StrategyState(inner=_DGCState(velocity=u, residual=r)), msg


@dataclasses.dataclass(frozen=True)
class DGS(_SparseStrategy):
    """Ours: SAMomentum worker (paper Algorithm 3). One buffer, no
    residual; ``quantize`` composes wire quantization, ``engine`` picks the
    top-k selector."""

    name: str = "dgs"
    momentum: float = 0.7

    def init(self, params):
        return StrategyState(inner=samomentum.init(params))

    def step_rows(self, state, g2d, lrs, space):
        msg, new_sam = samomentum.tree_update_rows(
            state.inner, g2d, space, momentum=self.momentum, lrs=lrs,
            density=self.density, spec=self.spec)
        return StrategyState(inner=new_sam), msg


@dataclasses.dataclass(frozen=True)
class DGSPlain(_SparseStrategy):
    """Paper Algorithm 1: DGS transport without SAMomentum (residual top-k);
    worker side identical to GDAsync, kept as its own name for ablations."""

    name: str = "dgs_plain"

    def _delegate(self) -> GDAsync:
        return GDAsync(density=self.density, engine=self.engine,
                       quantize=self.quantize)

    def init(self, params):
        return self._delegate().init(params)

    def step_rows(self, state, g2d, lrs, space):
        return self._delegate().step_rows(state, g2d, lrs, space)


def msgd_step(params, velocity, grads, *, lr: float, momentum: float):
    """Single-node momentum SGD (the paper's MSGD baseline), Eq. (7), over
    trees of tensors."""
    p_leaves, paths = tree_flatten(params)
    v_leaves = tree_flatten(velocity)[0]
    g_leaves = tree_flatten(grads)[0]
    new_v = [engine_lib.velocity_accumulate(u, g, momentum=momentum, lr=lr)
             for u, g in zip(v_leaves, g_leaves)]
    new_p = [p - u for p, u in zip(p_leaves, new_v)]
    return tree_unflatten(paths, new_p), tree_unflatten(paths, new_v)


STRATEGIES = {
    "asgd": ASGD,
    "gd_async": GDAsync,
    "dgc_async": DGCAsync,
    "dgs": DGS,
    "dgs_plain": DGSPlain,
}


def make_strategy(name: str, **kw) -> Strategy:
    try:
        cls = STRATEGIES[name]
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; have {sorted(STRATEGIES)}")
    return cls(**kw)
