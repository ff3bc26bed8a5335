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

At model size M > 1 (``mesh.model``) every leaf of a ``"model"`` spec
(``sharding.param_specs`` at M) is held in M pieces: a rank of a
``ProcessMesh`` holds its piece of the parameters, the velocity and the
shardedps M and v; a ``LaneMesh`` keeps each leaf whole and runs each
shard's work on a copy of its piece.  The loss and gradients run through
the sharded forward (``models.tensor_parallel``), the exchange on each
shard's rows (``core.distributed``), with the hints at M, as the
reference's.

The prefill and serve steps take the local shards' parameter trees
(:meth:`PrefillStep.local_params`) at M > 1 and return each shard's
caches; the logits are whole.  A step computes on the rows of the batch it
is given (``batch_specs``).
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
from repro_torch.telemetry.trace import NULL

from . import sharding as shard_rules
from .mesh import model_axis_size

# the port's meshes have one data axis (its workers) beside "model"
DATA_AXES = ("data",)


def init_exchange_state(params, ex_cfg: ExchangeConfig, mesh,
                        shard_axes=None):
    """Zero exchange state of ``mesh``'s lanes: every leaf with the lanes'
    leading dim (a rank's: its shards')."""
    return init_state(params, ex_cfg, mesh.size, lanes=len(mesh.lanes),
                      shard_axes=shard_axes, model=mesh.model)


def _local_params(params, cfg, mesh):
    """The local shards' trees of whole ``params`` (contiguous copies of
    the pieces, so each shard computes at its own shapes)."""
    tp = mesh.model
    specs = shard_rules.param_specs(cfg, abstract_params(cfg), tp.size)
    return [shard_rules.shard_params(params, specs, m, tp.size)
            for m in tp.shards]


@dataclasses.dataclass
class TrainStep:
    """``step(params, ex_state, batch) -> (params, ex_state, loss)`` and
    its three parts, which callers may time apart.  ``params`` are updated
    in place and ``ex_state`` by the exchange (the reference donates
    both); ``loss`` is the workers' mean, a scalar tensor.

    ``recorder`` (``telemetry.Recorder``; the no-op ``NULL`` by default)
    records ``train/step`` around ``train/grads``, ``train/exchange`` and
    ``train/apply``; in ``grads`` per lane ``grads/lane`` around
    ``grads/forward``, ``grads/backward`` and ``grads/copy``; and the
    exchange's phases (``core.distributed``)."""

    cfg: mcfg.ModelConfig
    mesh: object
    ex_cfg: ExchangeConfig
    lr: float
    remat: bool
    hints: list
    recorder: object = NULL

    def init_state(self, params):
        return init_exchange_state(params, self.ex_cfg, self.mesh,
                                   self.hints)

    def grads(self, params, batch):
        """Each lane's loss and gradients on its rows of ``batch`` (the
        global batch, split evenly over the W workers).  Returns (grads,
        the lanes' losses ``(L,)``), every gradient leaf ``(L, *shape)``
        float32 (a rank's: its shard's)."""
        W = self.mesh.size
        B = batch["tokens"].shape[0]
        if B % W:
            raise ValueError(f"batch {B} does not split over {W} workers")
        b = B // W
        leaves, paths = tree_flatten(params)
        lanes = len(self.mesh.lanes)
        grads = [torch.empty((lanes,) + tuple(p.shape), dtype=torch.float32,
                             device=p.device) for p in leaves]
        tp = self.mesh.model
        if tp.size > 1:
            live, trees = self._live_shards(leaves, paths)
        span = self.recorder.span
        losses = []
        for i, w in enumerate(self.mesh.lanes):
            with span("grads/lane", lane=i):
                part = {key: val[w * b:(w + 1) * b]
                        for key, val in batch.items()}
                if tp.size > 1:
                    with span("grads/forward", lane=i):
                        loss = loss_fn(trees, part, self.cfg,
                                       remat=self.remat, tp=tp)[0]
                    with span("grads/backward", lane=i):
                        gs = torch.autograd.grad(loss,
                                                 [t for *_, t in live])
                    with span("grads/copy", lane=i):
                        for (li, index, _), g in zip(live, gs):
                            grads[li][i][index].copy_(g)
                    del gs
                    losses.append(loss.detach())
                    continue
                live_leaves = [p.detach().requires_grad_() for p in leaves]
                with span("grads/forward", lane=i):
                    loss = loss_fn(tree_unflatten(paths, live_leaves), part,
                                   self.cfg, remat=self.remat)[0]
                with span("grads/backward", lane=i):
                    gs = torch.autograd.grad(loss, live_leaves)
                with span("grads/copy", lane=i):
                    for dst, g in zip(grads, gs):
                        dst[i].copy_(g)
                del gs
                losses.append(loss.detach())
        return tree_unflatten(paths, grads), torch.stack(losses)

    def _live_shards(self, leaves, paths):
        """(live, the local shards' trees) for the sharded loss: ``live``
        lists (leaf index, the index of its gradient in the leaf's,
        tensor), a replicated leaf once, a sharded one per local shard --
        on lanes a copy of the shard's piece, on a rank the leaf itself."""
        tp = self.mesh.model
        cols, live = [], []
        for li, (p, ax) in enumerate(zip(leaves, self.hints)):
            if ax is None or not tp.lanes:
                t = p.detach().requires_grad_()
                live.append((li, (), t))
                cols.append([t] * len(tp.shards))
                continue
            c = p.shape[ax] // tp.size
            col = []
            for m in tp.shards:
                index = (slice(None),) * ax + (slice(m * c, (m + 1) * c),)
                t = p.detach()[index].contiguous().requires_grad_()
                live.append((li, index, t))
                col.append(t)
            cols.append(col)
        trees = [tree_unflatten(paths, [col[j] for col in cols])
                 for j in range(len(tp.shards))]
        return live, trees

    def exchange(self, ex_state, grads):
        return exchange(ex_state, grads, cfg=self.ex_cfg, lr=self.lr,
                        mesh=self.mesh, shard_axes=self.hints,
                        recorder=self.recorder)

    @staticmethod
    def apply(params, updates):
        """``params <- f32(params) - updates``, in place (an in-place
        subtraction computes in the promoted float32 and rounds once to
        the parameter's dtype)."""
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.sub_(u)

    def __call__(self, params, ex_state, batch):
        span = self.recorder.span
        with span("train/step"):
            with span("train/grads"):
                grads, losses = self.grads(params, batch)
            with span("train/exchange"):
                updates, ex_state = self.exchange(ex_state, grads)
            del grads
            with span("train/apply"):
                self.apply(params, updates)
            return params, ex_state, self.mesh.mean(losses)


def whole_params(params, cfg: mcfg.ModelConfig, mesh):
    """The whole parameter tree on every rank of a model axis (its shards
    gathered over the model group); ``params`` itself on lanes and at
    model size 1."""
    tp = mesh.model
    if tp.lanes or tp.size == 1:
        return params
    leaves, paths = tree_flatten(params)
    specs = tree_flatten(shard_rules.param_specs(cfg, abstract_params(cfg),
                                                 tp.size))[0]
    return tree_unflatten(paths, [
        shard_rules.unshard_leaf(list(tp.all_gather(p)), spec)
        if "model" in spec else p for p, spec in zip(leaves, specs)])


def build_train_step(cfg: mcfg.ModelConfig, mesh, ex_cfg: ExchangeConfig,
                     *, lr: float = 1e-2, remat: bool = True) -> TrainStep:
    if ex_cfg.engine != "auto":
        from repro_torch.core.engine import get_engine
        get_engine(ex_cfg.engine)  # fail fast at build time
    hints = shard_rules.shard_axis_hints(cfg, abstract_params(cfg),
                                         model_axis_size(mesh))
    return TrainStep(cfg=cfg, mesh=mesh, ex_cfg=ex_cfg, lr=lr, remat=remat,
                     hints=hints)


@dataclasses.dataclass
class PrefillStep:
    """``step(params, batch) -> (last-position logits, caches)``;
    ``batch_specs`` is the batch's layout over the data axes.  At model
    size > 1 ``params`` is :meth:`local_params`' list and the caches one
    tree per local shard."""

    cfg: mcfg.ModelConfig
    mesh: object
    batch_specs: dict

    def local_params(self, params):
        """The local shards' trees of whole ``params`` (``params`` itself
        at model size 1)."""
        if self.mesh.model.size == 1:
            return params
        return _local_params(params, self.cfg, self.mesh)

    def __call__(self, params, batch):
        logits, caches, _ = prefill(
            params, batch["tokens"], self.cfg,
            frontend_embeds=batch.get("frontend_embeds"),
            tp=self.mesh.model)
        return logits, caches


@dataclasses.dataclass
class ServeStep:
    """``step(params, caches, token, pos) -> (logits, caches)``: one
    ``decode_step``, the caches updated in place (the reference donates
    them).  ``cache_specs`` is the caches' layout as the reference's rule
    gives it; at model size > 1 the port's shard holds its KV heads (or
    the KV heads its query heads read), the whole MLA latent and its heads
    of the SSM state (``tensor_parallel.init_caches``)."""

    cfg: mcfg.ModelConfig
    mesh: object
    long_mode: bool
    cache_specs: dict

    local_params = PrefillStep.local_params

    def __call__(self, params, caches, token, pos):
        return decode_step(params, caches, token, pos, self.cfg,
                           long_mode=self.long_mode, tp=self.mesh.model)


def build_prefill_step(cfg: mcfg.ModelConfig, mesh, *, shape) -> PrefillStep:
    return PrefillStep(cfg=cfg, mesh=mesh, batch_specs=shard_rules.batch_specs(
        cfg, input_specs(cfg, shape), DATA_AXES))


def build_serve_step(cfg: mcfg.ModelConfig, mesh, *, shape) -> ServeStep:
    cspecs = shard_rules.cache_specs(
        cfg, input_specs(cfg, shape)["caches"], DATA_AXES,
        model_axis_size(mesh), batch=shape.global_batch, n_data=mesh.size)
    return ServeStep(cfg=cfg, mesh=mesh, long_mode=shape.long,
                     cache_specs=cspecs)


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
