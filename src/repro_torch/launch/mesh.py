"""The data-parallel mesh of the port's training path: where the W workers
of the exchange live and how their collectives run (the port's stand-in
for ``repro.launch.mesh`` and the reference's ``shard_map`` over the data
axes).

The reference's exchange is per-device code with four collectives:
``all_gather``, a tiled ``all_to_all``, the linear device index and
``pmean``.  The port's exchange (``core/distributed.py``) is written once
against the same four operations, every per-worker tensor carrying a
leading *lane* dim ``L``, and runs on either mesh:

* :class:`LaneMesh` -- all W workers in one process on one device,
  ``L = W``: a gather is the identity, the all-to-all a transpose of the
  first two dims.  The counterpart of the reference's one-device leg of
  ``shard_exchange_batch``, which its tests pin to its collective.
* :class:`ProcessMesh` -- one worker per process, ``L = 1``, the
  collectives ``torch.distributed``'s.

The mean over workers is a sum left to right over the W workers' values,
then divided by W, on both meshes (``all_reduce`` sums in an order NCCL
chooses), so both give the same bits.  The ``"model"`` axis has size 1:
tensor parallelism is not ported.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


class _Mesh:
    size: int
    device: torch.device

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


class LaneMesh(_Mesh):
    """W workers as W lanes of one process on ``device`` (None = the
    card)."""

    def __init__(self, n_workers: int, device=None):
        self.size = int(n_workers)
        self.device = resolve_device(device)
        self.lanes = tuple(range(self.size))

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
    """One worker per process of ``group`` (None = the default group),
    computing on ``device`` (None = the card).

    Where the group's backend is gloo and ``device`` is a card -- several
    ranks sharing one card, which NCCL refuses -- every collective stages
    its operand explicitly: copied to the host, exchanged there, copied
    back to the card."""

    def __init__(self, group=None, device=None):
        # None names the default group at each call: a mesh holding the
        # default group's object would keep it alive past
        # ``destroy_process_group``, and its destructor would then run at
        # interpreter exit, where gloo's threads can abort the process
        self.group = group
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.device = resolve_device(device)
        self.lanes = (self.rank,)
        self.staged = (self.device.type != "cpu"
                       and dist.get_backend(self.group) == "gloo")

    def _send(self, x):
        x = x.contiguous()
        return x.cpu() if self.staged else x

    def gather(self, x):
        """``(1, ...)`` -> ``(W, ...)``, row i rank i's."""
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
        """``(1, W_dst, ...)`` -> ``(1, W_src, ...)``: row i is what rank i
        sent to this rank."""
        src = self._send(x[0])
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return out.to(self.device)[None]

    def index(self):
        return torch.tensor([self.rank], dtype=torch.int32,
                            device=self.device)


def init_process_mesh(rank: int, world_size: int, init_method: str,
                      device=None) -> ProcessMesh:
    """Join the default process group and return its mesh.  The backend is
    gloo on the CPU; on cards, NCCL when every rank of this host has a card
    of its own (``LOCAL_WORLD_SIZE``, default ``world_size``, at most the
    host's cards; a rank takes card ``LOCAL_RANK``, default ``rank``), else
    gloo with staged operands.

    The NCCL leg has not yet been run on several cards: only the gloo leg
    (CPU, and two ranks staging through one card's host) is held to the
    lanes bit for bit."""
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
    return ProcessMesh(device=device)
