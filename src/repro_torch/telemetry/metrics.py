"""On-device flight-recorder metrics (PyTorch port of
``repro.telemetry.metrics``): fixed-shape counters and bounded histograms
carried through the event loops as tensors on the run's device.

Telemetry adds no host sync to the loops and changes no data-plane bit:

* :class:`MetricsState` is a small fixed-shape tuple of int32 counters and
  log2-bucketed histograms.  Updating it is a handful of index-adds that
  only READ stage outputs (messages, staleness, worker ids); nothing feeds
  back into the training arithmetic.
* The host-known operands (worker ids, staleness) go to the device with a
  non-blocking copy from pinned memory; nothing is read back until
  :func:`drain`, at eval points or at the end of the run.
* Every histogram counts integers and every bucket boundary is a power of
  two, so the same event stream gives the same state in the serial and the
  batched loop.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.sparsify import SparseLeaf
from repro_torch.device import from_host, resolve_device

# log2 buckets: bucket b holds integer x with floor(log2(x+1)) == b, i.e.
# x in [2^b - 1, 2^(b+1) - 2]; larger values clip into the last bucket
N_BINS = 24

# update-magnitude buckets: bucket 0 is exactly-zero, bucket b >= 1 holds
# squared L2 norms with floor(log2(sq)) == b - 1 - MAG_OFFSET
MAG_BINS = 64
MAG_OFFSET = 40


class MetricsState(NamedTuple):
    """Fixed-shape on-device telemetry accumulator (one per run)."""

    n_events: torch.Tensor       # () int32 -- events folded in so far
    per_worker: torch.Tensor     # (n_workers,) int32 -- events per worker
    stale_hist: torch.Tensor     # (N_BINS,) int32 -- per-event staleness
    up_nnz_hist: torch.Tensor    # (N_BINS,) int32 -- shipped upward nnz
    down_nnz_hist: torch.Tensor  # (N_BINS,) int32 -- shipped downward nnz
    mag_hist: torch.Tensor       # (MAG_BINS,) int32 -- |G|^2 exponent buckets
    overflow: torch.Tensor       # () int32 -- entries dropped at a capacity


def init(n_workers: int, device=None) -> MetricsState:
    """A zero state on ``device`` (None = the card)."""
    dev = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    return MetricsState(n_events=zeros(), per_worker=zeros(n_workers),
                        stale_hist=zeros(N_BINS), up_nnz_hist=zeros(N_BINS),
                        down_nnz_hist=zeros(N_BINS), mag_hist=zeros(MAG_BINS),
                        overflow=zeros())


def log2_bin(x: torch.Tensor, n_bins: int = N_BINS) -> torch.Tensor:
    """floor(log2(x + 1)) clipped to [0, n_bins), in float32 as the
    reference computes it."""
    xf = torch.clamp(x, min=0).to(torch.float32)
    b = torch.floor(torch.log2(xf + 1.0)).to(torch.int32)
    return torch.clamp(b, 0, n_bins - 1)


def mag_bin(sq: torch.Tensor) -> torch.Tensor:
    """Exponent bucket of a squared L2 norm; 0 is reserved for exact zero."""
    sqf = sq.to(torch.float32)
    b = torch.floor(torch.log2(torch.clamp(sqf, min=2.0 ** (-MAG_OFFSET))))
    b = b.to(torch.int32) + (MAG_OFFSET + 1)
    return torch.where(sqf > 0, torch.clamp(b, 1, MAG_BINS - 1),
                       torch.zeros_like(b))


def msg_nnz(msg) -> torch.Tensor:
    """Shipped nnz of an (optionally batched) message.  Sparse messages
    have the static frame occupancy k (what the codec prices); dense
    messages count true non-zeros along the arena axis."""
    if isinstance(msg, SparseLeaf):
        return torch.full(msg.values.shape[:-1], msg.values.shape[-1],
                          dtype=torch.int32, device=msg.values.device)
    return (msg != 0.0).sum(dim=-1).to(torch.int32)


def msg_sqnorm(msg) -> torch.Tensor:
    """Squared L2 norm of an (optionally batched) message's values."""
    vals = msg.values if isinstance(msg, SparseLeaf) else msg
    return torch.sum(vals.to(torch.float32) ** 2, dim=-1)


def fold_(ms: MetricsState, worker_ids: torch.Tensor,
          staleness: torch.Tensor, up_nnz, down_nnz, mag_sq) -> MetricsState:
    """Fold one event (scalars) or one batch (``(B,)`` tensors) in, IN
    PLACE, every operand a tensor on the state's device: the fold a CUDA
    graph replays, which reads the worker id and the staleness from device
    memory and leaves the result where the next replay reads it.
    Duplicate buckets within a batch add, so the result equals folding the
    events one at a time.  Returns ``ms``."""

    def count_(hist, bins):
        bins = bins.reshape(-1).to(torch.int64)
        hist.index_add_(0, bins, torch.ones_like(bins, dtype=hist.dtype))

    wid = worker_ids.reshape(-1).to(torch.int64)
    ms.n_events.add_(int(wid.numel()))
    count_(ms.per_worker, wid)
    count_(ms.stale_hist, log2_bin(staleness.reshape(-1)))
    count_(ms.up_nnz_hist, log2_bin(up_nnz))
    count_(ms.down_nnz_hist, log2_bin(down_nnz))
    count_(ms.mag_hist, mag_bin(mag_sq))
    return ms


def update(ms: MetricsState, worker_ids, staleness, up_nnz, down_nnz,
           mag_sq, overflow=0) -> MetricsState:
    """:func:`fold_` into a new state, ``worker_ids`` and ``staleness``
    host values (numpy or ints), the rest device tensors; ``overflow``
    adds to the dropped-entry counter."""
    dev = ms.n_events.device
    wid = from_host(np.asarray(worker_ids, np.int64).reshape(-1), dev)
    stal = from_host(np.asarray(staleness, np.int64).reshape(-1), dev)
    if not isinstance(overflow, torch.Tensor):
        overflow = torch.full((), int(np.sum(overflow)), dtype=torch.int32,
                              device=dev)
    out = fold_(MetricsState(*(t.clone() for t in ms)), wid, stal, up_nnz,
                down_nnz, mag_sq)
    out.overflow.add_(overflow.sum().to(torch.int32))
    return out


def make_metrics_step():
    """The metrics fold of the event loops: reads the SHIPPED up/down
    messages plus host-known worker ids and staleness, after the data-plane
    stages and apart from them; one fold per event (serial) or per batch
    (batched), no host sync."""

    def step(ms, worker_ids, staleness, up_msg, down_msg):
        return update(ms, worker_ids, staleness, msg_nnz(up_msg),
                      msg_nnz(down_msg), msg_sqnorm(down_msg))

    return step


# ------------------------------------------------------------------ drain

def _bin_label(b: int) -> str:
    lo, hi = (1 << b) - 1, (1 << (b + 1)) - 2
    return str(lo) if lo == hi else f"{lo}-{hi}"


def _mag_label(b: int) -> str:
    if b == 0:
        return "0"
    return f"2^{b - 1 - MAG_OFFSET}"


def hist_dict(counts, labeler=_bin_label) -> dict:
    """Histogram counts -> the JSON schema of the JSONL records: trailing
    zero buckets trimmed, labels naming each bucket's range."""
    if isinstance(counts, torch.Tensor):
        counts = counts.cpu().numpy()
    counts = [int(c) for c in np.asarray(counts)]
    last = max((i for i, c in enumerate(counts) if c), default=0)
    counts = counts[:last + 1]
    return {"bins": [labeler(b) for b in range(len(counts))],
            "counts": counts}


def drain(ms: MetricsState) -> dict:
    """Copy the accumulator to the host (the ONLY host sync telemetry
    makes -- call at eval points or at the end of the run)."""
    return {
        "n_events": int(ms.n_events),
        "per_worker": ms.per_worker.cpu().tolist(),
        "staleness_hist": hist_dict(ms.stale_hist),
        "up_nnz_hist": hist_dict(ms.up_nnz_hist),
        "down_nnz_hist": hist_dict(ms.down_nnz_hist),
        "update_mag_hist": hist_dict(ms.mag_hist, labeler=_mag_label),
        "route_overflow": int(ms.overflow),
    }


def summarize_log2(x, n_bins: int = N_BINS) -> dict:
    """Host-side twin of the on-device log2 histogram (same buckets, same
    schema) for values already on the host."""
    x = np.maximum(np.asarray(x, np.float64), 0.0)
    b = np.clip(np.floor(np.log2(x + 1.0)).astype(np.int64), 0, n_bins - 1)
    return hist_dict(np.bincount(b, minlength=n_bins))
