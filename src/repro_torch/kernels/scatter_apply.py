"""In-place sparse scatter-adds with duplicate indices summed in update
order and indices outside ``[0, n)`` dropped: kernel 1 of the port, the
flat ``dense[idx] += vals``, and kernel 4, its multi-row twin
``dense2d[rows[b], idx2d[b]] += vals2d[b]`` for pairwise-distinct rows --
one range-partition kernel with no sort (``csrc/scatter_apply.cu``), the
flat call its one-lane case.

Replace the TPU's blocked kernels (``repro/kernels/scatter_apply.py``,
``scatter_apply_blocked`` and ``scatter_apply_blocked_rows``): the TPU
streams whole arena rows through VMEM; the Hopper kernel touches only the
target words, in place.

Each wrapper takes a CPU tensor to its plain version and launches its
kernel for a CUDA tensor; anything else raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

INFO = build.KernelInfo(
    name="scatter_add",
    source="src/repro_torch/kernels/csrc/scatter_apply.cu",
    replaces="src/repro/kernels/scatter_apply.py:33")
# kept updates a CTA applies per round (kCap in csrc/scatter_apply.cu); a
# share beyond it takes several rounds
ROUND = 2048
# lanes per launch of the multi-row kernel (kMaxLanes): their row ids
# travel in the launch's parameters
MAX_LANES = 512

ROWS_INFO = build.KernelInfo(
    name="scatter_add_rows",
    source="src/repro_torch/kernels/csrc/scatter_apply.cu",
    replaces="src/repro/kernels/scatter_apply.py:65")


def scatter_add_plain(dense: torch.Tensor, indices: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, in place: indices outside ``[0, n)`` dropped,
    the same stable sort, then the values of each run of equal indices
    added in their original order, ``((d + v0) + v1)``, one rank of every
    run per pass."""
    idx = indices.to(torch.int64)
    ok = (idx >= 0) & (idx < dense.shape[0])
    idx, vals = idx[ok], values.to(dense.dtype)[ok]
    if idx.numel() == 0:
        return dense
    sidx, perm = torch.sort(idx, stable=True)
    vals = vals[perm]
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
    ``dense``.  CPU -> plain version, CUDA -> ONE launch of the kernel (no
    sort, no allocation; none at all for k = 0)."""
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
    k = indices.numel()
    if k:
        rc = build.library().scatter_add(
            dense.data_ptr(), dense.numel(), indices.data_ptr(),
            values.data_ptr(), k, build.stream())
        build.check(rc, INFO.name)
        build.count(INFO)
    return dense


def _host_rows(rows, n_rows: int, n_lanes: int) -> list:
    """The lanes' target rows as host ints, checked: ``None`` means the
    rows ``0..B-1``; else one per lane, in range and pairwise distinct (the
    batching rule), so no two lanes write one word."""
    if rows is None:
        if n_lanes > n_rows:
            raise ValueError(f"scatter_add_rows_: {n_lanes} lanes for "
                             f"{n_rows} rows")
        return list(range(n_lanes))
    rows = np.asarray(rows, dtype=np.int64).reshape(-1).tolist()
    if len(rows) != n_lanes:
        raise ValueError(f"scatter_add_rows_: {len(rows)} rows for "
                         f"{n_lanes} lanes")
    if rows and (min(rows) < 0 or max(rows) >= n_rows):
        raise ValueError(f"scatter_add_rows_: rows {rows} outside "
                         f"[0, {n_rows})")
    if len(set(rows)) != len(rows):
        raise ValueError(f"scatter_add_rows_: rows {rows} are not pairwise "
                         f"distinct")
    return rows


def _device_rows(rows: torch.Tensor, dense2d: torch.Tensor,
                 n_lanes: int) -> torch.Tensor:
    """The lanes' target rows as a tensor on ``dense2d``'s device (a CUDA
    graph's replay reads them there): int64, one per lane.  Their values
    are not read on the host: ids outside the rows are dropped, and the
    caller keeps them pairwise distinct."""
    if rows.device != dense2d.device or rows.dtype != torch.int64 \
            or rows.numel() != n_lanes:
        raise ValueError(f"scatter_add_rows_: device rows {rows.dtype} "
                         f"{tuple(rows.shape)} on {rows.device} for "
                         f"{n_lanes} lanes on {dense2d.device}")
    return rows.reshape(-1).contiguous()


def scatter_add_rows_plain(dense2d: torch.Tensor, rows, idx2d: torch.Tensor,
                           vals2d: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, in place: each lane's in-range updates moved
    to flat coordinates ``rows[b] * n + idx``, then the same stable sort
    and in-order run sums as :func:`scatter_add_plain` (distinct rows keep
    every lane's run inside its own row).  ``rows`` as for
    :func:`scatter_add_rows_`."""
    n_rows, n = dense2d.shape
    if isinstance(rows, torch.Tensor):
        row = _device_rows(rows, dense2d, idx2d.shape[0])[:, None]
        row_ok = (row >= 0) & (row < n_rows)
    else:
        row = torch.tensor(_host_rows(rows, n_rows, idx2d.shape[0]),
                           dtype=torch.int64, device=dense2d.device)[:, None]
        row_ok = True
    idx = idx2d.to(torch.int64)
    ok = (idx >= 0) & (idx < n) & row_ok
    flat = row * n + idx
    scatter_add_plain(dense2d.view(-1), flat[ok], vals2d.to(dense2d.dtype)[ok])
    return dense2d


def scatter_add_rows_(dense2d: torch.Tensor, rows, idx2d: torch.Tensor,
                      vals2d: torch.Tensor) -> torch.Tensor:
    """``dense2d[rows[b], idx2d[b]] += vals2d[b]`` in place for every lane
    b; returns ``dense2d``.  ``rows`` is a host sequence of pairwise
    distinct row ids (checked), ``None`` for the rows ``0..B-1``, or an
    int64 tensor of row ids on ``dense2d``'s device, one per lane (pairwise
    distinct by the caller's contract, ids outside the rows dropped: what a
    CUDA graph's replay reads).  CPU -> plain version, CUDA -> kernel 4:
    ONE launch for up to ``MAX_LANES`` lanes, the host row ids in its
    parameters (none for ``None``), the device ones by pointer; no device
    copy."""
    if dense2d.device.type == "cpu":
        return scatter_add_rows_plain(dense2d, rows, idx2d, vals2d)
    if dense2d.device.type != "cuda":
        raise ValueError(f"scatter_add_rows_: no kernel for {dense2d.device}")
    build.require(dense2d, "dense2d", torch.float32, dense2d.device)
    build.require(idx2d, "idx2d", torch.int32, dense2d.device)
    build.require(vals2d, "vals2d", torch.float32, dense2d.device)
    if dense2d.dim() != 2 or idx2d.dim() != 2 \
            or vals2d.shape != idx2d.shape:
        raise ValueError(f"scatter_add_rows_: shapes {tuple(dense2d.shape)}, "
                         f"{tuple(idx2d.shape)}, {tuple(vals2d.shape)}")
    lanes, k = idx2d.shape
    table = rows_dev = None
    if isinstance(rows, torch.Tensor):
        rows_dev = _device_rows(rows, dense2d, lanes)
    else:
        ids = _host_rows(rows, dense2d.shape[0], lanes)
        if rows is not None:
            table = (ctypes.c_int32 * lanes)(*ids)
    if lanes and k:
        rc = build.library().scatter_add_rows(
            dense2d.data_ptr(), dense2d.shape[1], table,
            None if rows_dev is None else rows_dev.data_ptr(),
            dense2d.shape[0], lanes, idx2d.data_ptr(), vals2d.data_ptr(), k,
            build.stream())
        build.check(rc, ROWS_INFO.name)
        build.count(ROWS_INFO, -(-lanes // MAX_LANES))
    return dense2d
