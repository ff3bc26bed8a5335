"""The (data x model) mesh of the port's training and serving paths: where
the W data workers of the exchange and the M model shards of each live and
how their collectives run (the port's counterpart of ``repro.launch.mesh``
and of the reference's ``shard_map`` over the data axes with the
``"model"`` axis left to GSPMD).

The reference's exchange is per-device code with four collectives over
the data axes: ``all_gather``, a tiled ``all_to_all``, the linear device
index and ``pmean``.  The port's exchange (``core/distributed.py``) is
written once against the same four operations, every per-worker tensor
carrying a leading *lane* dim ``L``, and runs on either mesh:

* :class:`LaneMesh` -- all W x M cells in one process on one device,
  ``L = W``: a gather is the identity, the all-to-all a transpose of the
  first two dims.  The counterpart of the reference's one-device leg of
  ``shard_exchange_batch``, which its tests pin to its collective.
* :class:`ProcessMesh` -- one cell per process, ``L = 1``, the collectives
  ``torch.distributed``'s.  Rank ``r`` is cell ``(r // M, r % M)``, the
  row-major device order of ``jax.make_mesh((W, M), ("data", "model"))``;
  the data collectives run over the ranks of its model shard (its *data
  group*), the model collectives over the ranks of its data worker (its
  *model group*).

The mean over workers is a sum left to right over the W workers' values,
then divided by W, on both meshes (``all_reduce`` sums in an order NCCL
chooses), so both give the same bits.

The ``"model"`` axis (:class:`ModelAxis`, ``mesh.model``) is what the
sharded forward (``models.tensor_parallel``) sees: M shards, of which a
process runs all (lanes) or its own (a rank), and five operations on the
shards' tensors, each an explicit ``torch.autograd.Function`` with its
mirror as the backward:

* ``sum``     -- the M shards' partials added left to right (float32
  accumulation), the same tensor on every shard; backward: the output's
  gradient to every partial.
* ``copy_in`` -- a replicated tensor handed to each shard; backward: the
  shards' gradients summed left to right.  On the lanes too: if M shards
  used one tensor, autograd would add their gradients in an order of its
  own, and lanes and ranks would part in the last bit.
* ``gather``  -- the shards' pieces concatenated along a dim, replicated;
  backward: each shard's piece of the (replicated) gradient.
* ``split``   -- a replicated tensor cut into the shards' pieces; backward:
  the pieces' gradients concatenated.
* ``max``     -- the shards' maxima (no gradient).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# the model axis
# ---------------------------------------------------------------------------

def _sum_left(parts):
    """``parts[0] + parts[1] + ...`` left to right in float32, rounded once
    to the parts' dtype."""
    total = parts[0].to(torch.float32)
    for x in parts[1:]:
        total = total + x.to(torch.float32)
    return total.to(parts[0].dtype)


class _LaneSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        ctx.n = len(parts)
        return _sum_left(parts)

    @staticmethod
    def backward(ctx, g):
        return (g,) * ctx.n


class _LaneCopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        live = [g for g in grads if g is not None]
        return (_sum_left(live) if live else None), None


class _LaneGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.dim, ctx.sizes = dim, [p.shape[dim] for p in parts]
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(x.contiguous()
                               for x in g.split(ctx.sizes, ctx.dim))


class _LaneSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n):
        pieces = x.chunk(n, dim)
        ctx.dim, ctx.shapes = dim, [c.shape for c in pieces]
        return tuple(c.contiguous() for c in pieces)

    @staticmethod
    def backward(ctx, *grads):
        ref = next(g for g in grads if g is not None)
        return torch.cat([torch.zeros(shape, dtype=ref.dtype,
                                      device=ref.device) if g is None else g
                          for g, shape in zip(grads, ctx.shapes)],
                         ctx.dim), None, None


class _RankSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _sum_left(list(axis.all_gather(x)))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RankCopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_left(list(ctx.axis.all_gather(g))), None


class _RankGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.size = dim, axis, x.shape[dim]
        return torch.cat(list(axis.all_gather(x)), dim)

    @staticmethod
    def backward(ctx, g):
        m = ctx.axis.rank
        return g.narrow(ctx.dim, m * ctx.size, ctx.size).contiguous(), \
            None, None


class _RankSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return x.chunk(axis.size, dim)[axis.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(list(ctx.axis.all_gather(g)), ctx.dim), None, None


class ModelAxis:
    """The ``"model"`` mesh axis: ``size`` shards, of which this process
    runs ``shards`` (every one on lanes; its own, ``rank``, over
    ``group``).  Its operations take and return one tensor per local
    shard (lists), except where a result is replicated."""

    def __init__(self, size: int = 1, *, rank: int | None = None,
                 group=None, staged: bool = False):
        self.size = int(size)
        self.rank = rank
        self.group = group
        self.staged = staged
        self.shards = tuple(range(self.size)) if rank is None else (rank,)

    @property
    def lanes(self) -> bool:
        return self.rank is None

    def all_gather(self, x):
        """``x`` of every shard, stacked ``(M, ...)`` (ranks only)."""
        src = x.contiguous()[None]
        dev = src.device
        if self.staged:
            src = src.cpu()
        out = torch.empty((self.size,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(out, src, group=self.group)
        return out.to(dev)

    def sum(self, parts):
        """The shards' partials summed left to right: one tensor, the same
        bits on every shard."""
        if self.lanes:
            return _LaneSum.apply(*parts)
        return _RankSum.apply(parts[0], self)

    def copy_in(self, x):
        """A replicated tensor, one alias per local shard."""
        if self.lanes:
            return list(_LaneCopyIn.apply(x, len(self.shards)))
        return [_RankCopyIn.apply(x, self)]

    def gather(self, parts, dim: int):
        """The shards' pieces concatenated along ``dim``, replicated."""
        if self.lanes:
            return _LaneGather.apply(dim, *parts)
        return _RankGather.apply(parts[0], dim, self)

    def split(self, x, dim: int):
        """A replicated tensor's M even pieces along ``dim``, one per
        local shard."""
        if self.lanes:
            return list(_LaneSplit.apply(x, dim, self.size))
        return [_RankSplit.apply(x, dim, self)]

    def max(self, parts):
        """The elementwise maximum of the shards' tensors (detached)."""
        parts = [p.detach() for p in parts]
        if self.lanes:
            return torch.stack(parts).amax(0)
        return self.all_gather(parts[0]).amax(0)


# ---------------------------------------------------------------------------
# the meshes
# ---------------------------------------------------------------------------

class _Mesh:
    size: int
    device: torch.device
    model: ModelAxis

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The workers' mean of ``(L, ...)``, ``(...)`` on every worker:
        their values gathered, summed left to right, divided by W."""
        parts = self.gather(x)
        total = parts[0]
        for w in range(1, self.size):
            total = total + parts[w]
        return total / self.size

    @property
    def shape(self) -> dict:
        """``{"data": W, "model": M}``, as ``dict(jax_mesh.shape)``."""
        return {"data": self.size, "model": self.model.size}


class LaneMesh(_Mesh):
    """W data workers x M model shards as lanes of one process on
    ``device`` (None = the card).  Every sharded leaf stays whole here;
    each shard's work runs on its own slice, at its own shapes."""

    def __init__(self, n_workers: int, device=None, *, model: int = 1):
        self.size = int(n_workers)
        self.device = resolve_device(device)
        self.lanes = tuple(range(self.size))
        self.model = ModelAxis(model)

    def gather(self, x):
        """``(W, ...)`` -> ``(W, ...)``: every lane already holds it."""
        return x

    def all_to_all(self, x):
        """``(L, W_dst, ...)`` -> ``(L, W_src, ...)``: row i of lane l's
        result is what lane i sent to lane l."""
        return x.transpose(0, 1).contiguous()

    def index(self):
        """The lanes' worker indices, ``(L,)`` int32."""
        return torch.arange(self.size, dtype=torch.int32, device=self.device)


class ProcessMesh(_Mesh):
    """One (data, model) cell per process of the default group, computing
    on ``device`` (None = the card).  ``model`` shards a data worker; the
    data collectives run over ``group`` (None = the default group, at
    ``model`` 1), the model ones over the model group.

    Where the group's backend is gloo and ``device`` is a card -- several
    ranks sharing one card, which NCCL refuses -- every collective stages
    its operand explicitly: copied to the host, exchanged there, copied
    back to the card."""

    def __init__(self, group=None, device=None, *, model: int = 1):
        # None names the default group at each call: a mesh holding the
        # default group's object would keep it alive past
        # ``destroy_process_group``, and its destructor would then run at
        # interpreter exit, where gloo's threads can abort the process
        world = dist.get_world_size()
        rank = dist.get_rank()
        if world % model:
            raise ValueError(f"{world} ranks do not split into model "
                             f"shards of {model}")
        self.device = resolve_device(device)
        self.staged = (self.device.type != "cpu"
                       and dist.get_backend() == "gloo")
        n_data = world // model
        model_group = None
        if model > 1:
            # every rank creates every group, in the same order
            data_groups = [dist.new_group([d * model + m
                                           for d in range(n_data)])
                           for m in range(model)]
            model_groups = [dist.new_group([d * model + m
                                            for m in range(model)])
                            for d in range(n_data)]
            group = data_groups[rank % model]
            model_group = model_groups[rank // model]
        self.group = group
        self.size = n_data
        self.rank = rank // model
        self.lanes = (self.rank,)
        self.model = ModelAxis(model, rank=rank % model, group=model_group,
                               staged=self.staged)

    def close(self):
        """Drop the mesh's sub-groups (call before
        ``destroy_process_group``, which then frees them)."""
        self.group = None
        self.model.group = None

    def _send(self, x):
        x = x.contiguous()
        return x.cpu() if self.staged else x

    def gather(self, x):
        """``(1, ...)`` -> ``(W, ...)``, row i data worker i's."""
        src = self._send(x)
        out = torch.empty((self.size,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        # all_gather_into_tensor is deprecated under this name in newer
        # torch releases
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(out, src, group=self.group)
        return out.to(self.device)

    def all_to_all(self, x):
        """``(1, W_dst, ...)`` -> ``(1, W_src, ...)``: row i is what data
        worker i sent to this rank."""
        src = self._send(x[0])
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return out.to(self.device)[None]

    def index(self):
        return torch.tensor([self.rank], dtype=torch.int32,
                            device=self.device)


def init_process_mesh(rank: int, world_size: int, init_method: str,
                      device=None, *, model: int = 1) -> ProcessMesh:
    """Join the default process group and return its mesh of
    ``world_size / model`` data workers x ``model`` shards.  The backend is
    gloo on the CPU; on cards, NCCL when every rank of this host has a
    card of its own (``LOCAL_WORLD_SIZE``, default ``world_size``, at most
    the host's cards; a rank takes card ``LOCAL_RANK``, default ``rank``),
    else gloo with staged operands.

    The NCCL leg has not yet been run on several cards: only the gloo leg
    (CPU, and ranks staging through one card's host) is held to the lanes
    bit for bit."""
    import os

    device = resolve_device(device)
    backend = "gloo"
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if n_cards and local_world <= n_cards:
        backend = "nccl"
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return ProcessMesh(device=device, model=model)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes only: no lanes, no processes, no
    device.  ``size`` is its data workers (the ``"pod"`` and ``"data"``
    axes folded, as :func:`make_mesh` folds them), ``model_size`` its
    ``"model"`` axis."""

    axes: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(n for a, n in zip(self.axes, self.sizes)
                         if a in ("pod", "data"))

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    @property
    def n_devices(self) -> int:
        return math.prod(self.sizes)


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production meshes (``make_production_mesh``): one
    pod of (16 data, 16 model), or two of them, (2 pod, 16 data, 16
    model)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_mesh(shape, axes, device=None) -> LaneMesh:
    """A :class:`LaneMesh` of ``shape`` over ``axes`` (the data axes,
    ``"pod"`` and ``"data"``, fold into its workers), as the reference's
    ``make_mesh((2, 2), ("data", "model"))``."""
    sizes = dict(zip(axes, shape))
    return LaneMesh(math.prod(sizes[a] for a in axes if a in ("pod", "data")),
                    device, model=sizes.get("model", 1))


def data_axis_names(mesh) -> tuple[str, ...]:
    """The port's meshes have one data axis."""
    return ("data",)


def n_data_workers(mesh) -> int:
    return mesh.size


def model_axis_size(mesh) -> int:
    return mesh.model.size
