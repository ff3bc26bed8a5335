"""Deterministic event-driven simulator for asynchronous PS training
(PyTorch port of the serial loop of ``repro.core.async_sim``).

Every worker owns a local model arena and strategy state; a schedule of
worker ids (from simulated heterogeneous speeds) fixes the order in which
workers reach the server.  Each event runs four stages -- client compute,
server receive + select, server commit, worker apply -- with the wire
quantizer between them, exactly as the reference decomposes them.

Everything runs on ``AsyncTrainer.device``: the card unless the caller asks
for the CPU (``device="cpu"``, as the tests do).  There is no silent
fallback: without CUDA, the default device raises.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.cluster import wire
from repro_torch.device import resolve_device

from . import engine as engine_lib
from . import server as ps
from .baselines import Strategy
from .engine import CompressionSpec
from .paramspace import ParamSpace, tree_flatten, tree_unflatten


def make_schedule(n_workers: int, n_events: int, *, seed: int = 0,
                  hetero: float = 0.5) -> np.ndarray:
    """Event order from simulated worker speeds: exponential service times
    with per-worker rates drawn lognormal(0, hetero); ties resolve to the
    lowest worker id.  Pure numpy, identical to the reference."""
    rng = np.random.default_rng(seed)
    speeds = np.exp(rng.normal(0.0, hetero, n_workers))
    scale = 1.0 / speeds
    t_next = rng.exponential(scale)
    heap = [(float(t_next[k]), k) for k in range(n_workers)]
    heapq.heapify(heap)
    order = np.empty(n_events, dtype=np.int32)
    for e in range(n_events):
        t, k = heapq.heappop(heap)
        order[e] = k
        heapq.heappush(heap, (t + rng.exponential(scale[k]), k))
    return order


def staleness_of(schedule, n_workers: int) -> np.ndarray:
    """Per-event staleness (server updates since the worker last synced)."""
    last_sync = np.zeros(n_workers, dtype=np.int64)
    out = np.zeros(len(schedule), dtype=np.int64)
    for e, k in enumerate(schedule):
        out[e] = e - last_sync[k]
        last_sync[k] = e + 1
    return out


class History(NamedTuple):
    losses: np.ndarray          # (n_events,)
    worker_ids: np.ndarray      # (n_events,)
    staleness: np.ndarray       # (n_events,)
    up_bytes: int               # total upward wire bytes
    down_bytes: int             # total downward wire bytes
    evals: list                 # [(event_idx, metric), ...]


# ---------------------------------------------------------------------------
# The four per-event stages, decomposed as the reference (and its cluster
# runtime) runs them.  Wire quantization happens BETWEEN stages via
# wire.quantize_message, never inside the strategy step.
# ---------------------------------------------------------------------------

def strip_quantize(strategy: Strategy) -> Strategy:
    """The strategy with in-engine wire quantization disabled: the wire
    owns value quantization."""
    if strategy.quantize == "none":
        return strategy
    return dataclasses.replace(strategy, quantize="none")


def client_step_fn(strategy: Strategy, grad_fn, space: ParamSpace):
    """Client compute: grads on the stale local model (the arena unpacked
    to views for ``grad_fn``) + strategy step.  Returns (new strategy
    state, loss, RAW upward message)."""
    strategy = strip_quantize(strategy)

    def client_step(theta, wstrat, batch, lr):
        loss, grads = grad_fn(space.unpack(theta), batch)
        wstrat, msg = strategy.step(wstrat, grads, lr)
        return wstrat, loss, msg

    return client_step


def server_step_fn(secondary_density, spec: CompressionSpec):
    """Server: apply the upward message (M in place), select the RAW
    downward one."""

    def server_step(sstate, msg, worker_id):
        sstate = ps.receive(sstate, msg)
        G = ps.send_select(sstate, worker_id,
                           secondary_density=secondary_density, spec=spec)
        return sstate, G

    return server_step


# The reference wraps each stage in jax.jit; PyTorch runs eagerly, so the
# factories hand out the stage callables themselves.
make_client_step = client_step_fn
make_server_step = server_step_fn


def make_commit():
    """Server commit: fold the SHIPPED downward message into v_k (in
    place)."""
    return ps.send_commit


def make_apply():
    """Worker apply: theta <- theta + G (Eq. 5), in place."""
    return ps.apply_update


def _to_device(tree, device):
    leaves, paths = tree_flatten(tree)
    return tree_unflatten(paths, [l.to(device) for l in leaves])


@dataclasses.dataclass
class AsyncTrainer:
    """Asynchronous PS training loop over a gradient function.

    grad_fn(params, batch) -> (loss, grads), params and grads being dicts of
    tensors on ``device`` (None = the card).
    """

    strategy: Strategy
    grad_fn: Callable
    n_workers: int
    lr: float
    secondary_density: float | None = None
    secondary_spec: CompressionSpec = engine_lib.EXACT_SPEC
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def init(self, params0):
        params0 = _to_device(params0, self.device)
        theta0 = ParamSpace.from_tree(params0).pack(params0)
        workers = [
            # per-worker copies: apply updates each theta in place
            {"theta": theta0.clone(), "strat": self.strategy.init(params0)}
            for _ in range(self.n_workers)
        ]
        return ps.init(params0, self.n_workers), workers

    def run(self, params0, schedule: np.ndarray,
            batch_fn: Callable[[int, int], Any], *,
            lr_fn: Callable[[int], float] | None = None,
            eval_fn: Callable | None = None, eval_every: int = 0):
        """Run the full schedule.  batch_fn(event_idx, worker_id) -> batch.
        Returns (final params, server state, History)."""
        params0 = _to_device(params0, self.device)
        space = ParamSpace.from_tree(params0)
        sstate, workers = self.init(params0)
        client_step = make_client_step(self.strategy, self.grad_fn, space)
        server_step = make_server_step(self.secondary_density,
                                       self.secondary_spec)
        commit, apply_G = make_commit(), make_apply()
        up_mode = self.strategy.quantize
        down_mode = self.secondary_spec.quantize
        up_seg = self.strategy.message_seg(space)
        down_seg = (space.ks(self.secondary_density)
                    if self.secondary_density is not None else None)
        # sparse frame sizes are static per (mode, seg, total); dense ones
        # depend on the nonzero count, kept on the device until the end
        up_cost = (wire.frame_bytes_static(up_seg, space.total, up_mode)
                   if up_seg is not None else None)
        down_cost = (wire.frame_bytes_static(down_seg, space.total, down_mode)
                     if down_seg is not None else None)
        losses: list = []
        up_nnz: list = []
        down_nnz: list = []
        up_bytes = down_bytes = 0
        evals = []
        stal = staleness_of(schedule, self.n_workers)
        for e, k in enumerate(schedule):
            k = int(k)
            lr = self.lr if lr_fn is None else float(lr_fn(e))
            batch = batch_fn(e, k)
            wst, loss, msg = client_step(
                workers[k]["theta"], workers[k]["strat"], batch, lr)
            msg = wire.quantize_message(msg, up_mode, seg=up_seg)
            sstate, G = server_step(sstate, msg, k)
            G = wire.quantize_message(G, down_mode, seg=down_seg)
            sstate = commit(sstate, k, G)
            workers[k]["theta"] = apply_G(workers[k]["theta"], G)
            workers[k]["strat"] = wst
            losses.append(loss.detach())
            if up_cost is not None:
                up_bytes += up_cost
            else:
                up_nnz.append(torch.count_nonzero(msg))
            if down_cost is not None:
                down_bytes += down_cost
            else:
                down_nnz.append(torch.count_nonzero(G))
            if eval_fn is not None and eval_every and (e + 1) % eval_every == 0:
                evals.append((e + 1, eval_fn(ps.global_model(params0,
                                                             sstate))))
        final = ps.global_model(params0, sstate)
        if up_nnz:
            up_bytes += int(np.sum(wire.ENVELOPE_BYTES + wire.dense_frame_bytes(
                torch.stack(up_nnz).cpu().numpy(), space.total)))
        if down_nnz:
            down_bytes += int(np.sum(wire.ENVELOPE_BYTES + wire.dense_frame_bytes(
                torch.stack(down_nnz).cpu().numpy(), space.total)))
        hist = History(
            losses=torch.stack(losses).cpu().numpy().astype(np.float64),
            worker_ids=np.asarray(schedule),
            staleness=stal,
            up_bytes=up_bytes,
            down_bytes=down_bytes,
            evals=evals,
        )
        return final, sstate, hist
