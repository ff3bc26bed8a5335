"""Model-difference-tracking parameter server (paper §4, Algorithm 2) --
PyTorch port of the flat server of ``repro.core.server``.

The server stores ``M`` = theta_t - theta_0 (Eq. 2) and, per worker k,
``v_k`` = everything already shipped to worker k (Eq. 4):

    Upward:   M <- M - decode(g_k)
    Downward: G_k <- M - v_k  (optionally secondary-compressed, Eq. 6a/6b)
              v_k <- v_k + G_k

``M`` is one ``(total,)`` f32 arena and ``v`` one ``(n_workers, total)``
buffer.  Where the reference's jitted stages donate them, the port updates
them IN PLACE: :func:`receive` writes ``M``, :func:`send_commit` writes row
``v[k]``, :func:`reset_worker` zeroes it and :func:`apply_update` writes the
worker's ``theta``.  Each sparse update is ONE scatter (kernel 1 on a card).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import engine as engine_lib
from .engine import CompressionSpec
from .paramspace import ParamSpace, tree_leaves
from .sparsify import SparseLeaf


class ServerState(NamedTuple):
    M: torch.Tensor     # (total,) f32 arena
    v: torch.Tensor     # (n_workers, total) f32
    t: int              # update timestamp
    space: ParamSpace   # arena descriptor


def init(params, n_workers: int) -> ServerState:
    space = ParamSpace.from_tree(params)
    device = tree_leaves(params)[0].device
    return ServerState(
        M=torch.zeros(space.total, dtype=torch.float32, device=device),
        v=torch.zeros((n_workers, space.total), dtype=torch.float32,
                      device=device),
        t=0, space=space)


def receive(state: ServerState, msg) -> ServerState:
    """Apply one worker's (sparse or dense) arena update to M, in place."""
    from repro_torch.kernels import ops

    if isinstance(msg, SparseLeaf):
        ops.scatter_add(state.M, msg.indices, -msg.values)
    else:  # dense flat arena (ASGD)
        state.M.sub_(msg)
    return state._replace(t=state.t + 1)


def send_select(state: ServerState, worker_id: int, *,
                secondary_density: float | None = None,
                spec: CompressionSpec = engine_lib.EXACT_SPEC):
    """Select the RAW (unquantized) downward message G_k; no state change.
    The caller quantizes it, and :func:`send_commit` is fed what shipped."""
    diff = state.M - state.v[worker_id]
    if secondary_density is None:
        return diff
    spec_raw = dataclasses.replace(spec, quantize="none")
    return state.space.select(diff, state.space.ks(secondary_density),
                              spec_raw)


def send_commit(state: ServerState, worker_id: int, G) -> ServerState:
    """Account the SHIPPED message into v_k (Eq. 4), in place.  A dense G
    means "everything": v_k becomes a copy of M (``v + (M - v)`` would lose
    bits to f32 cancellation)."""
    from repro_torch.kernels import ops

    if isinstance(G, SparseLeaf):
        ops.scatter_add_row(state.v, worker_id, G.indices, G.values)
    else:
        state.v[worker_id].copy_(state.M)
    return state


def send(state: ServerState, worker_id: int, *,
         secondary_density: float | None = None,
         spec: CompressionSpec = engine_lib.EXACT_SPEC):
    """Produce G_k for ``worker_id``: :func:`send_select` + in-spec wire
    quantization + :func:`send_commit`.  Returns (state, G)."""
    G = send_select(state, worker_id, secondary_density=secondary_density,
                    spec=spec)
    if isinstance(G, SparseLeaf):
        G = engine_lib.quantize_arena(G, spec.quantize,
                                      state.space.ks(secondary_density))
    return send_commit(state, worker_id, G), G


def add_worker(state: ServerState) -> tuple[ServerState, int]:
    """Grow v by one zero row (elastic join); returns the new slot id."""
    new_id = int(state.v.shape[0])
    new_v = torch.cat([state.v, torch.zeros_like(state.v[:1])])
    return state._replace(v=new_v), new_id


def reset_worker(state: ServerState, worker_id: int) -> ServerState:
    """Zero a departed worker's v row, in place, so the slot can serve a
    new client (which starts from theta_0)."""
    state.v[worker_id].zero_()
    return state


def apply_update(theta: torch.Tensor, G) -> torch.Tensor:
    """Worker-side arena update theta <- theta + G (Eq. 5), in place."""
    from repro_torch.kernels import ops

    if isinstance(G, SparseLeaf):
        return ops.scatter_add(theta, G.indices, G.values)
    return theta.add_(G.to(theta.dtype))


def apply_to_params(params, G):
    """Tree convenience wrapper around :func:`apply_update`."""
    space = ParamSpace.from_tree(params)
    return space.unpack(apply_update(space.pack(params), G))


def global_model(params0, state: ServerState):
    """theta_t = theta_0 + M_t (Eq. 2) -- used by tests and evaluation."""
    space = state.space
    return space.unpack(space.pack(params0) + state.M)


def message_nnz(G) -> int:
    """True non-zero count of a downward message (comm accounting)."""
    if isinstance(G, SparseLeaf):
        return int(G.values.shape[0])
    return int(torch.count_nonzero(G))
