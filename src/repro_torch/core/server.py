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
The batched loop's :func:`send_commit_rows` and :func:`apply_update_rows`
fold a whole batch into its pairwise-distinct rows with ONE multi-row
scatter (kernel 4); :func:`send_commit` is that scatter at B = 1.

A worker id is a host int, or (the scan runner, whose CUDA graph replays
one event for every worker) a one-element int64 tensor on the server's
device: :func:`send_select` and :func:`send_commit` then index ``v`` on
the device and read nothing back.

The sharded servers: a shard of the S-thread runtime is a plain
:class:`ServerState` over the sub-arena a leaf-aligned
:class:`~.paramspace.ShardSpec` gives it (:func:`init_shards`); the mesh
server keeps all S shard arenas stacked in ONE :class:`MeshServerState`,
``M: (S, width)`` and ``v: (n_workers, S, width)``, on the device of
``params0`` (:func:`init_mesh_shards`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import from_host

from . import engine as engine_lib
from .engine import CompressionSpec
from .paramspace import ParamSpace, ShardSpec, tree_leaves
from .sparsify import SparseLeaf


class ServerState(NamedTuple):
    M: torch.Tensor     # (total,) f32 arena
    v: torch.Tensor     # (n_workers, total) f32
    t: int              # update timestamp
    space: ParamSpace   # arena descriptor


def init(params, n_workers: int, device=None) -> ServerState:
    """A zero server over ``params``' arena, on ``device`` (None = the
    device of ``params``; an empty shard's tree has none, so its caller
    names one)."""
    space = ParamSpace.from_tree(params)
    if device is None:
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


def _row(v: torch.Tensor, worker_id) -> torch.Tensor:
    """Row ``worker_id`` of ``v``: a view for a host int, a gathered copy
    for a device id."""
    if isinstance(worker_id, torch.Tensor):
        return v.index_select(0, worker_id.reshape(1))[0]
    return v[worker_id]


def send_select(state: ServerState, worker_id, *,
                secondary_density: float | None = None,
                spec: CompressionSpec = engine_lib.EXACT_SPEC):
    """Select the RAW (unquantized) downward message G_k; no state change.
    The caller quantizes it, and :func:`send_commit` is fed what shipped."""
    diff = state.M - _row(state.v, worker_id)
    if secondary_density is None:
        return diff
    spec_raw = dataclasses.replace(spec, quantize="none")
    return state.space.select(diff, state.space.ks(secondary_density),
                              spec_raw)


def send_commit(state: ServerState, worker_id, G) -> ServerState:
    """Account the SHIPPED message into v_k (Eq. 4), in place: a sparse G
    with ONE multi-row scatter at B = 1 (kernel 4, as the batched commit).
    A dense G means "everything": v_k becomes a copy of M (``v + (M - v)``
    would lose bits to f32 cancellation)."""
    from repro_torch.kernels import ops

    if isinstance(G, SparseLeaf):
        ops.scatter_add_row(state.v, worker_id, G.indices, G.values)
    elif isinstance(worker_id, torch.Tensor):
        state.v.index_copy_(0, worker_id.reshape(1), state.M[None])
    else:
        state.v[worker_id].copy_(state.M)
    return state


def _device_ids(worker_ids, device) -> torch.Tensor:
    return from_host(np.asarray(worker_ids, np.int64), device)


def send_commit_rows(state: ServerState, worker_ids, G,
                     M_rows=None) -> ServerState:
    """Account a whole batch of SHIPPED messages into their ``v`` rows, in
    place (Eq. 4, one event per batch lane).

    ``worker_ids`` is a host array of pairwise-distinct ids (the batching
    rule), so the rows are disjoint and ONE multi-row scatter is bit-equal
    to committing the events one :func:`send_commit` at a time.  ``G`` is
    the stacked batch: a SparseLeaf with ``(B, k)`` values/indices, or a
    dense ``(B, total)`` stack.  A dense commit snaps each row to M *as of
    its event*, the ``M_rows[i]`` prefix the batched receive captured, not
    to the post-batch M.
    """
    from repro_torch.kernels import ops

    if isinstance(G, SparseLeaf):
        ops.scatter_add_rows(state.v, worker_ids, G.indices, G.values)
    else:
        if M_rows is None:
            raise ValueError("dense batched commit needs the per-event "
                             "prefix M_rows")
        state.v.index_copy_(0, _device_ids(worker_ids, state.v.device),
                            M_rows)
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


def add_worker(state):
    """Grow v by one zero row (elastic join); returns ``(state, slot id)``.
    A mesh state's ``v`` grows by one ``(S, width)`` row."""
    new_id = int(state.v.shape[0])
    new_v = torch.cat([state.v, torch.zeros_like(state.v[:1])])
    return state._replace(v=new_v), new_id


def reset_worker(state, worker_id: int):
    """Zero a departed worker's v row (a mesh state's ``(S, width)`` row),
    in place, so the slot can serve a new client (which starts from
    theta_0)."""
    state.v[worker_id].zero_()
    return state


def apply_update(theta: torch.Tensor, G) -> torch.Tensor:
    """Worker-side arena update theta <- theta + G (Eq. 5), in place."""
    from repro_torch.kernels import ops

    if isinstance(G, SparseLeaf):
        return ops.scatter_add(theta, G.indices, G.values)
    return theta.add_(G.to(theta.dtype))


def apply_update_rows(thetas: torch.Tensor, worker_ids, G) -> torch.Tensor:
    """Batched worker apply, in place on the stacked ``(n_workers, total)``
    models: row ``worker_ids[b]`` gets lane b of ``G`` (ONE multi-row
    scatter for a sparse batch).  Returns ``thetas``."""
    from repro_torch.kernels import ops

    if isinstance(G, SparseLeaf):
        return ops.scatter_add_rows(thetas, worker_ids, G.indices, G.values)
    ids = _device_ids(worker_ids, thetas.device)
    rows = thetas.index_select(0, ids)
    rows.add_(G.to(thetas.dtype))
    return thetas.index_copy_(0, ids, rows)


def apply_to_params(params, G):
    """Tree convenience wrapper around :func:`apply_update`."""
    space = ParamSpace.from_tree(params)
    return space.unpack(apply_update(space.pack(params), G))


def global_model(params0, state):
    """theta_t = theta_0 + M_t (Eq. 2) -- used by tests and evaluation.
    Takes the flat :class:`ServerState` or the stacked
    :class:`MeshServerState` (whose padded M concatenates back to the same
    global arena bit for bit)."""
    space = state.space
    M = mesh_arena(state) if isinstance(state, MeshServerState) else state.M
    return space.unpack(space.pack(params0).to(M.device) + M)


def message_nnz(G) -> int:
    """True non-zero count of a downward message (comm accounting)."""
    if isinstance(G, SparseLeaf):
        return int(G.values.shape[0])
    return int(torch.count_nonzero(G))


# ---------------------------------------------------------------------------
# Sharded parameter server.  A shard is a plain ServerState over the
# sub-arena of the tensors a leaf-aligned ShardSpec assigns to it, so every
# per-shard stage is the flat server's own; shard index ranges are disjoint,
# so the shards run independently and reproduce the single server bit for
# bit (scatter-adds over disjoint ranges commute).
# ---------------------------------------------------------------------------

def _leaf_aligned(params, n_shards: int, shard_spec: ShardSpec | None,
                  what: str) -> ShardSpec:
    if shard_spec is None:
        shard_spec = ShardSpec.for_space(ParamSpace.from_tree(params),
                                         n_shards)
    if shard_spec.leaf_splits is None:
        raise ValueError(f"the {what} server needs a leaf-aligned "
                         f"ShardSpec (ShardSpec.for_space)")
    return shard_spec


def shard_params(params, shard_spec: ShardSpec) -> list:
    """Per-shard sub-trees of a parameter tree (leaf-aligned spec): each
    flattens to the leaves its shard owns, in arena order."""
    return [shard_spec.shard_tree(params, s)
            for s in range(shard_spec.n_shards)]


def init_shards(params, n_workers: int, n_shards: int,
                shard_spec: ShardSpec | None = None,
                ) -> tuple[ShardSpec, tuple[ServerState, ...]]:
    """Range-partition the arena into ``n_shards`` independent servers:
    ``(shard_spec, states)``, ``states[s]`` a :class:`ServerState` over
    shard ``s``'s index range, on the device of ``params``."""
    shard_spec = _leaf_aligned(params, n_shards, shard_spec, "sharded")
    device = tree_leaves(params)[0].device
    states = tuple(init(part, n_workers, device)
                   for part in shard_params(params, shard_spec))
    return shard_spec, states


def global_model_shards(params0, states):
    """theta_t from per-shard states: the shard M slices concatenate (shard
    order == leaf order) back into the global arena, bit-equal to
    :func:`global_model` of the single server."""
    space = ParamSpace.from_tree(params0)
    M = torch.cat([st.M for st in states if st.space.total])
    return space.unpack(space.pack(params0) + M)


# ---------------------------------------------------------------------------
# Mesh server.  ALL shard arenas live in one stacked (S, width) /
# (n_workers, S, width) pair, so one stage runs every shard server at once;
# global-index messages reach their owner shard through the route exchange
# (``distributed.shard_exchange_batch``).  Rows are padded to a common width:
# padding columns hold zeros, are never routed to (local indices are below
# sizes[s]) and are sliced away by ``mesh_concat``, so ragged and empty
# shards stay legal and the arithmetic is bit-equal to the flat server.
# ---------------------------------------------------------------------------

class MeshServerState(NamedTuple):
    M: torch.Tensor         # (S, width) f32, row s = shard s's arena, padded
    v: torch.Tensor         # (n_workers, S, width) f32
    t: int                  # update timestamp
    overflow: torch.Tensor  # int64 scalar on the device: route-capacity
                            # drops (0 with the default cap)
    space: ParamSpace       # the GLOBAL arena descriptor
    spec: ShardSpec         # the range partition


def mesh_width(spec: ShardSpec) -> int:
    """Common padded row width: ``even_stride`` unless a leaf-aligned
    shard is bigger (``for_space`` keeps tensors whole)."""
    return max([ShardSpec.even_stride(spec.total, spec.n_shards),
                *spec.sizes])


def init_mesh_shards(params, n_workers: int, n_shards: int,
                     shard_spec: ShardSpec | None = None) -> MeshServerState:
    """The stacked mesh twin of :func:`init_shards`: one state for all
    shards, on the device of ``params``."""
    space = ParamSpace.from_tree(params)
    shard_spec = _leaf_aligned(params, n_shards, shard_spec, "mesh-sharded")
    if shard_spec.total != space.total:
        raise ValueError("shard_spec does not cover the parameter arena")
    device = tree_leaves(params)[0].device
    w, S = mesh_width(shard_spec), shard_spec.n_shards
    return MeshServerState(
        M=torch.zeros((S, w), dtype=torch.float32, device=device),
        v=torch.zeros((n_workers, S, w), dtype=torch.float32, device=device),
        t=0, overflow=torch.zeros((), dtype=torch.int64, device=device),
        space=space, spec=shard_spec)


def mesh_split(spec: ShardSpec, x: torch.Tensor,
               width: int | None = None) -> torch.Tensor:
    """Cut one global ``(total,)`` arena vector into the padded ``(S,
    width)`` stack (padding columns zero)."""
    width = mesh_width(spec) if width is None else width
    out = x.new_zeros((spec.n_shards, width))
    for s, (a, b) in enumerate(zip(spec.bounds[:-1], spec.bounds[1:])):
        out[s, :b - a] = x[a:b]
    return out


def mesh_concat(spec: ShardSpec, xs: torch.Tensor) -> torch.Tensor:
    """Undo :func:`mesh_split`: each row cut at its true shard size and
    the rows concatenated (shard order == leaf order) to ``(total,)``."""
    parts = [xs[s, :sz] for s, sz in enumerate(spec.sizes) if sz]
    if not parts:
        return xs.new_zeros((0,))
    return torch.cat(parts)


def mesh_arena(state: MeshServerState) -> torch.Tensor:
    """The global M arena of a mesh state (checkpoints, serving, eval)."""
    return mesh_concat(state.spec, state.M)
