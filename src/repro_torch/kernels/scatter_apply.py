"""In-place sparse scatter-add: ``dense[idx] += vals`` with duplicate indices
summed in update order -- kernel 1 of the port (``csrc/scatter_apply.cu``).

Replaces the TPU's blocked kernel (``repro/kernels/scatter_apply.py``,
``scatter_apply_blocked``): the TPU streams the whole arena through VMEM per
event; the Hopper kernel touches only the k target words, in place.

The wrapper takes a CPU tensor to :func:`scatter_add_plain` and launches
the kernel for a CUDA tensor; anything else raises.
"""
from __future__ import annotations

import torch

from . import build

INFO = build.KernelInfo(
    name="scatter_add",
    source="src/repro_torch/kernels/csrc/scatter_apply.cu",
    replaces="src/repro/kernels/scatter_apply.py:33")


def scatter_add_plain(dense: torch.Tensor, indices: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, in place: the same stable sort, then the
    values of each run of equal indices added in their original order,
    ``((d + v0) + v1)``, one rank of every run per pass."""
    if indices.numel() == 0:
        return dense
    sidx, perm = torch.sort(indices.to(torch.int64), stable=True)
    vals = values.to(dense.dtype)[perm]
    uniq, counts = torch.unique_consecutive(sidx, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    acc = dense[uniq]
    for rank in range(int(counts.max())):
        live = counts > rank
        acc[live] = acc[live] + vals[starts[live] + rank]
    dense[uniq] = acc
    return dense


def scatter_add_(dense: torch.Tensor, indices: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """``dense[indices] += values`` in place on a flat f32 tensor; returns
    ``dense``.  CPU -> plain version, CUDA -> the kernel."""
    if dense.device.type == "cpu":
        return scatter_add_plain(dense, indices, values)
    if dense.device.type != "cuda":
        raise ValueError(f"scatter_add_: no kernel for {dense.device}")
    build.require(dense, "dense", torch.float32, dense.device)
    build.require(indices, "indices", torch.int32, dense.device)
    build.require(values, "values", torch.float32, dense.device)
    if dense.dim() != 1 or indices.dim() != 1 \
            or values.shape != indices.shape:
        raise ValueError(f"scatter_add_: shapes {tuple(dense.shape)}, "
                         f"{tuple(indices.shape)}, {tuple(values.shape)}")
    sidx, perm = torch.sort(indices, stable=True)
    rc = build.library().scatter_add_sorted(
        dense.data_ptr(), dense.numel(), sidx.data_ptr(), perm.data_ptr(),
        values.data_ptr(), indices.numel(), build.stream())
    build.check(rc, INFO.name)
    INFO.launches += 1
    return dense
