"""Roofline terms of one step of the port on an NVIDIA H100 (the port's
counterpart of ``repro.launch.roofline``, whose constants are a TPU
v5e's and whose terms come from XLA's ``cost_analysis`` and an HLO
parse, neither of which torch has):

    compute term    = flops_per_device / PEAK_FLOPS[compute dtype]
    memory term     = bytes_per_device / HBM_RATE of the card
    collective term = wire_bytes_per_device / LINK_RATE

* FLOPs per device: ``torch.utils.flop_counter.FlopCounterMode`` over one
  step of one device's work (:func:`count_flops`), on the meta device or
  on real tensors alike (the count is a function of the shapes).
* Wire bytes per device: the exchange's static bytes over the data axes
  (:func:`wire_bytes`, from ``distributed.leaf_cut``, the cut the
  exchanges themselves use) plus what the model axis moves, counted by
  :class:`MetaAxis` at every collective of that step.
* Bytes per device: a lower bound reckoned from the shards (each
  resident tensor read once, each written leaf written once), not a
  measured traffic.

The card's constants are spec-sheet peaks (NVIDIA's H100 SXM data sheet,
dense, no sparsity), which assume the card at its full power limit: the
NVIDIA H100 80GB HBM3 at 700 W.  They are not measurements.
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.launch.mesh import ModelAxis

# device memory rate by card, bytes/s (NVIDIA data sheets); the longest
# name the card's name holds wins
HBM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12,
            "H200": 4.8e12}
HBM_BW = HBM_RATE["H100"]
# dense tensor-core bf16 and float32 outside the tensor cores, H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# NVLink 4 of an H100 SXM: 900 GB/s both ways together, 450 GB/s each way
# (what one card can send while it receives as much)
LINK_RATE = 450e9


def hbm_rate(name: str) -> float:
    """The memory rate of the card named ``name``
    (``torch.cuda.get_device_name``)."""
    for key in sorted(HBM_RATE, key=len, reverse=True):
        if key in name:
            return HBM_RATE[key]
    raise RuntimeError(f"no memory rate known for {name!r}")


@dataclasses.dataclass
class RooflineReport:
    """The reference's report, its fields and ``row()`` keys kept.  In the
    port ``flops_per_device`` is ``FlopCounterMode``'s count and
    ``bytes_per_device`` the reckoned lower bound (the ``hlo_*`` keys
    keep the reference's names)."""

    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    collective_counts: dict
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float          # 6*N(active)*D, global
    n_devices: int
    peak_bytes_per_device: float | None = None

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        per_dev_model = self.model_flops / max(1, self.n_devices)
        return per_dev_model / self.flops_per_device if \
            self.flops_per_device else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops_per_device": self.flops_per_device,
            "hlo_bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "useful_flops_ratio": self.useful_flops_ratio,
            "collective_counts": self.collective_counts,
            "peak_bytes_per_device": self.peak_bytes_per_device,
        }


def model_flops(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE), D = tokens processed; decode
    processes global_batch tokens per step; train includes backward (the 6x
    already covers fwd+bwd; for inference steps we use 2*N*D)."""
    n = cfg.param_count()
    if cfg.moe is not None:
        e = cfg.moe
        gates = 3 if cfg.activation in ("swiglu", "geglu") else 2
        expert_params = (cfg.n_layers * e.n_experts * gates
                         * cfg.d_model * e.d_expert)
        active = (cfg.n_layers * e.top_k * gates * cfg.d_model * e.d_expert)
        n = n - expert_params + active
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def report(*, arch: str, shape, mesh_name: str, cfg, n_devices: int,
           flops: float, nbytes: float, wire: float,
           collective_counts: dict) -> RooflineReport:
    """The three terms at the H100's peaks (``cfg``'s compute dtype); no
    peak memory (the reference's comes from XLA's buffer assignment)."""
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name,
        flops_per_device=flops, bytes_per_device=nbytes,
        wire_bytes_per_device=wire, collective_counts=collective_counts,
        compute_s=flops / PEAK_FLOPS[cfg.compute_dtype],
        memory_s=nbytes / HBM_BW, collective_s=wire / LINK_RATE,
        model_flops=model_flops(cfg, shape), n_devices=n_devices)


def count_flops(fn) -> int:
    """The FLOPs of ``fn()`` as ``FlopCounterMode`` counts them (matrix
    products, convolutions and attention, by their shapes)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def wire_bytes(ex_cfg, n_workers: int, shapes, hints, model: int = 1) -> int:
    """The bytes one device receives from the data axes' exchange per
    step, from the static k's of the exchange's own cut
    (``distributed.leaf_cut``) of each whole leaf (``shapes``) and its
    model hint: allgather ``W * k * (value + index bytes)`` (k ``k_row *
    S`` for a leaf of S rows), shardedps ``S * (W * cap + W * k2) *
    (value + index bytes)``, dense ``4 * P``.  At ``model`` size M a
    device runs 1/M of a hinted leaf's rows; a leaf cut whole (a
    replicated leaf, a hinted vector) runs whole on every device.  Values
    travel in ``ex_cfg.wire_dtype`` (a leaf cut whole in float32),
    indices as int32."""
    from repro_torch.core.distributed import leaf_cut

    value = torch.empty((), dtype=getattr(torch, ex_cfg.wire_dtype)) \
        .element_size()
    total = 0
    for shape, ax in zip(shapes, hints):
        shape = tuple(shape)
        if ex_cfg.mode == "dense":
            total += 4 * torch.Size(shape).numel()
            continue
        c = leaf_cut(shape, ax, ex_cfg, n_workers)
        entry = (4 if c.flat else value) + 4
        n = (n_workers * c.S * c.k_row if ex_cfg.mode == "allgather"
             else c.S * (n_workers * c.cap + n_workers * c.k2)) * entry
        total += n // model if (model > 1 and ax is not None
                                and not c.flat) else n
    return total


class MetaAxis(ModelAxis):
    """Rank 0 of a model axis of ``size`` shards, alone in its process:
    each collective returns a tensor of the collective's shape built from
    this rank's operand (no other rank takes part), so one device's step
    runs on the meta device or on real tensors.  It counts the five
    operations (``counts``, forward calls) and every collective they
    start, forward and backward (``counts["all_gather"]``, and
    ``wire_bytes``: the gathered output's bytes, as the reference counts
    an all-gather)."""

    def __init__(self, size: int):
        super().__init__(size, rank=0)
        self.counts = collections.Counter()
        self.wire_bytes = 0

    def all_gather(self, x):
        self.counts["all_gather"] += 1
        self.wire_bytes += self.size * x.numel() * x.element_size()
        return x.contiguous()[None].expand((self.size,) + tuple(x.shape))

    def sum(self, parts):
        self.counts["sum"] += 1
        return super().sum(parts)

    def copy_in(self, x):
        self.counts["copy_in"] += 1
        return super().copy_in(x)

    def gather(self, parts, dim: int):
        self.counts["gather"] += 1
        return super().gather(parts, dim)

    def split(self, x, dim: int):
        self.counts["split"] += 1
        return super().split(x, dim)

    def max(self, parts):
        self.counts["max"] += 1
        return super().max(parts)
