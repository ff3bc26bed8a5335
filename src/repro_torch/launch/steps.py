"""The train, prefill and serve steps for (arch, mesh, input shape)
(PyTorch port of ``repro.launch.steps``).

train step topology, as the reference's ``shard_map`` over the data axes:

    per worker (lane): loss and gradients on its share of the batch
    DGS exchange: SAMomentum -> engine top-k -> sparse collective
    the workers' mean loss
    params <- params - updates

On a :class:`~repro_torch.launch.mesh.LaneMesh` the W workers' gradients
are computed one lane after another, each on its ``B/W`` rows of the
batch; on a :class:`~repro_torch.launch.mesh.ProcessMesh` each process
computes its own rank's.

The prefill and serve steps need no collective: the ``"model"`` axis has
size 1, and a worker's rows of the batch and the caches (``batch_specs``,
``cache_specs``) are served on their own.  A step computes on the rows it
is given.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.shapes import input_specs
from repro_torch.core.distributed import (ExchangeConfig, exchange,
                                          init_state)
from repro_torch.core.paramspace import (tree_flatten, tree_leaves,
                                         tree_unflatten)
from repro_torch.models import config as mcfg
from repro_torch.models.model import (abstract_params, decode_step, loss_fn,
                                      prefill)

from . import sharding as shard_rules

# the port's meshes have one data axis (its workers) and no model axis
DATA_AXES = ("data",)


def init_exchange_state(params, ex_cfg: ExchangeConfig, mesh,
                        shard_axes=None):
    """Zero exchange state of ``mesh``'s lanes: every leaf with the lanes'
    leading dim."""
    return init_state(params, ex_cfg, mesh.size, lanes=len(mesh.lanes),
                      shard_axes=shard_axes)


@dataclasses.dataclass
class TrainStep:
    """``step(params, ex_state, batch) -> (params, ex_state, loss)`` and
    its three parts, which callers may time apart.  ``params`` are updated
    in place and ``ex_state`` by the exchange (the reference donates
    both); ``loss`` is the workers' mean, a scalar tensor."""

    cfg: mcfg.ModelConfig
    mesh: object
    ex_cfg: ExchangeConfig
    lr: float
    remat: bool
    hints: list

    def init_state(self, params):
        return init_exchange_state(params, self.ex_cfg, self.mesh,
                                   self.hints)

    def grads(self, params, batch):
        """Each lane's loss and gradients on its rows of ``batch`` (the
        global batch, split evenly over the W workers).  Returns (grads,
        the lanes' losses ``(L,)``), every gradient leaf ``(L, *shape)``
        float32."""
        W = self.mesh.size
        B = batch["tokens"].shape[0]
        if B % W:
            raise ValueError(f"batch {B} does not split over {W} workers")
        b = B // W
        leaves, paths = tree_flatten(params)
        lanes = len(self.mesh.lanes)
        grads = [torch.empty((lanes,) + tuple(p.shape), dtype=torch.float32,
                             device=p.device) for p in leaves]
        losses = []
        for i, w in enumerate(self.mesh.lanes):
            part = {key: val[w * b:(w + 1) * b] for key, val in batch.items()}
            live = [p.detach().requires_grad_() for p in leaves]
            loss = loss_fn(tree_unflatten(paths, live), part, self.cfg,
                           remat=self.remat)[0]
            for dst, g in zip(grads, torch.autograd.grad(loss, live)):
                dst[i].copy_(g)
            losses.append(loss.detach())
        return tree_unflatten(paths, grads), torch.stack(losses)

    def exchange(self, ex_state, grads):
        return exchange(ex_state, grads, cfg=self.ex_cfg, lr=self.lr,
                        mesh=self.mesh, shard_axes=self.hints)

    @staticmethod
    def apply(params, updates):
        """``params <- f32(params) - updates``, in place (an in-place
        subtraction computes in the promoted float32 and rounds once to
        the parameter's dtype)."""
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.sub_(u)

    def __call__(self, params, ex_state, batch):
        grads, losses = self.grads(params, batch)
        updates, ex_state = self.exchange(ex_state, grads)
        del grads
        self.apply(params, updates)
        return params, ex_state, self.mesh.mean(losses)


def build_train_step(cfg: mcfg.ModelConfig, mesh, ex_cfg: ExchangeConfig,
                     *, lr: float = 1e-2, remat: bool = True) -> TrainStep:
    if ex_cfg.engine != "auto":
        from repro_torch.core.engine import get_engine
        get_engine(ex_cfg.engine)  # fail fast at build time
    # the "model" axis has size 1: tensor parallelism is not ported
    hints = shard_rules.shard_axis_hints(cfg, abstract_params(cfg), 1)
    return TrainStep(cfg=cfg, mesh=mesh, ex_cfg=ex_cfg, lr=lr, remat=remat,
                     hints=hints)


@dataclasses.dataclass
class PrefillStep:
    """``step(params, batch) -> (last-position logits, caches)``;
    ``batch_specs`` is the batch's layout over the data axes."""

    cfg: mcfg.ModelConfig
    batch_specs: dict

    def __call__(self, params, batch):
        logits, caches, _ = prefill(
            params, batch["tokens"], self.cfg,
            frontend_embeds=batch.get("frontend_embeds"))
        return logits, caches


@dataclasses.dataclass
class ServeStep:
    """``step(params, caches, token, pos) -> (logits, caches)``: one
    ``decode_step``, the caches updated in place (the reference donates
    them).  ``cache_specs`` is the caches' layout over the data axes."""

    cfg: mcfg.ModelConfig
    long_mode: bool
    cache_specs: dict

    def __call__(self, params, caches, token, pos):
        return decode_step(params, caches, token, pos, self.cfg,
                           long_mode=self.long_mode)


def build_prefill_step(cfg: mcfg.ModelConfig, mesh, *, shape) -> PrefillStep:
    return PrefillStep(cfg=cfg, batch_specs=shard_rules.batch_specs(
        cfg, input_specs(cfg, shape), DATA_AXES))


def build_serve_step(cfg: mcfg.ModelConfig, mesh, *, shape) -> ServeStep:
    # the "model" axis has size 1: tensor parallelism is not ported
    cspecs = shard_rules.cache_specs(
        cfg, input_specs(cfg, shape)["caches"], DATA_AXES, 1,
        batch=shape.global_batch, n_data=mesh.size)
    return ServeStep(cfg=cfg, long_mode=shape.long, cache_specs=cspecs)


def build_step(cfg, mesh, shape, *, ex_cfg: ExchangeConfig | None = None,
               lr: float = 1e-2):
    """One entry point: the step kind for the input shape."""
    if shape.kind == "train":
        return build_train_step(cfg, mesh,
                                ex_cfg or ExchangeConfig(mode="allgather"),
                                lr=lr)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape=shape)
    return build_serve_step(cfg, mesh, shape=shape)
