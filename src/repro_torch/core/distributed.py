"""DGS as a data-parallel gradient-exchange strategy over a mesh of workers
(PyTorch port of ``repro.core.distributed``).

The data-parallel axis is the worker fleet; in ``shardedps`` the parameter
server is *sharded across that axis* (each worker owns 1/W of every row of
a leaf).  Three exchange modes:

* ``dense``     -- baseline: the workers' mean gradient (the classic
                   all-reduce) and heavy-ball momentum.
* ``allgather`` -- paper-faithful: each worker top-k's its SAMomentum
                   velocity and all-gathers (values, indices); every worker
                   scatter-adds the union.
* ``shardedps`` -- dual-way: entries are bucketed by owner shard and
                   exchanged with one all-to-all; the owners aggregate into
                   their M shard and return the secondary-compressed
                   difference shard ``M - v`` through an all-gather.
                   Dropped overflow and the unsent remainder stay in
                   ``M - v``, as paper Eq. (6).

The exchange is written once against a mesh (``launch/mesh.py``): every
per-worker tensor carries a leading lane dim ``L`` -- ``W`` lanes of one
process (:class:`~repro_torch.launch.mesh.LaneMesh`) or one lane per
process (:class:`~repro_torch.launch.mesh.ProcessMesh`) -- and the
reference's collectives are the mesh's ``gather``, ``all_to_all``,
``index`` and ``mean``.  The gathered union is the same on every worker,
so it is scattered into the dense update ONCE per leaf, with kernel rows 1
and 2 (``kernels.ops.scatter_add``/``scatter_add_rows``), which add
duplicates in update order -- worker 0's entry, then worker 1's -- as the
reference's ``.at[].add``; an atomic scatter would let lanes, ranks and
runs drift by ulps.  Both meshes give the same bits.

The exchange writes the new velocity, M and v into the state's own
tensors (the reference donates them) and returns that state with the
update to subtract from the parameters.

A ``recorder`` (``telemetry.Recorder``; the no-op ``NULL`` by default)
records the exchange's phases as spans, per leaf (``leaf=``) and per lane
where the work is per lane: ``exchange/select`` (SAMomentum, top-k, the
rescale, shardedps' downward top-k2), ``exchange/layout`` (copies into
and out of the row layout, wire casts, the lanes' stacks, the gathered
transposes), ``exchange/bucket`` (shardedps' owner buckets),
``exchange/collective`` (the mesh's collectives) and ``exchange/scatter``
(the dense buffer, the union, M and v scatters, the ``1/W`` scale).

:func:`shard_exchange_batch` is the mesh server's route exchange: on one
card every shard's chunk is routed there and the buckets permuted; over a
``ProcessMesh`` of S ranks each rank routes its own source chunk and the
buckets cross with one ``all_to_all_single``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.arith import rcp
from repro_torch.telemetry.trace import NULL

from . import engine as engine_lib
from .engine import CompressionSpec
from .paramspace import ShardSpec, tree_flatten, tree_leaves, tree_unflatten
from .sparsify import density_to_k


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    mode: str = "dense"            # dense | allgather | shardedps
    density: float = 0.01          # upward top-k density (1 - R%)
    momentum: float = 0.9          # SAMomentum m
    secondary_density: float | None = None  # shardedps downward density;
                                            # default density/W at call site
    bucket_factor: float = 2.0     # all_to_all bucket overprovisioning
    engine: str = "auto"           # compression engine (core/engine.py):
                                   # exact | sampled | blockwise | auto
    quantize: str = "none"         # wire quantization of message values
    sampled_threshold_above: int = 1 << 20  # auto engine: sampled thr for
                                            # leaves/rows at least this big
    wire_dtype: str = "float32"    # collective payload dtype (bf16 halves
                                   # value bytes)

    def spec(self) -> CompressionSpec:
        """The compression-engine spec every selection in this exchange
        uses."""
        return CompressionSpec(
            engine=self.engine,
            quantize=self.quantize,
            sampled_threshold_above=self.sampled_threshold_above,
        )


class ExchangeState(NamedTuple):
    """Persistent per-worker exchange state, every leaf ``(L, ...)``."""

    velocity: Any        # SAMomentum velocity tree, (L, *shape)
    m_shard: Any         # sharded-PS: accumulated update, own shard only
    v_shard: Any         # sharded-PS: what has been broadcast already
    overflow: Any = ()   # sharded-PS: (L,) int32, entries dropped at the
                         # W*cap bucket slot; () when the mode has no
                         # buckets -- a read-only tap


def init_state(params, cfg: ExchangeConfig, n_workers: int, *,
               lanes: int = 1, shard_axes=None, model=None) -> ExchangeState:
    """Zero state for ``lanes`` of ``n_workers`` workers, on the
    parameters' device.  On a rank of a model axis (``model``, the mesh's
    :class:`~repro_torch.launch.mesh.ModelAxis`) ``params`` are the rank's
    shards and the shardedps M and v hold the rank's rows."""
    leaves, paths = tree_flatten(params)
    if shard_axes is None:
        shard_axes = [None] * len(leaves)

    def state_size(shape, ax):
        cut = model_axis_rule(shape, ax, cfg, n_workers, model)[1]
        return cut.S * cut.shard_rest

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((lanes,) + shape, dtype=dtype,
                           device=leaves[0].device)

    vel = [zeros(*p.shape) for p in leaves]
    if cfg.mode == "shardedps":
        m = [zeros(state_size(tuple(p.shape), ax))
             for p, ax in zip(leaves, shard_axes)]
        v = [torch.zeros_like(x) for x in m]
        ovf = zeros(dtype=torch.int32)
    else:
        m = [zeros(0) for _ in leaves]
        v = [zeros(0) for _ in leaves]
        ovf = ()
    return ExchangeState(velocity=tree_unflatten(paths, vel),
                         m_shard=tree_unflatten(paths, m),
                         v_shard=tree_unflatten(paths, v), overflow=ovf)


def _wire(dtype: str) -> torch.dtype:
    return getattr(torch, dtype)


# ---------------------------------------------------------------------------
# the model axis on ranks
#
# A hinted leaf is sharded over the "model" axis on its hinted dim, and the
# rows of its row view are the hinted dim's (times folded dims after it), so
# a shard's rows are one block of them: a model shard's exchange is the
# exchange of its rows, with the whole leaf's k_row and cut.  On lanes every
# leaf is whole and the exchange is the one of model size 1.
# ---------------------------------------------------------------------------

def model_axis_rule(shape, ax, cfg: ExchangeConfig, n_workers: int, model):
    """How a sparse exchange in ``cfg.mode`` runs a leaf of which this
    process holds ``shape``, hinted on dim ``ax``: ``(how, cut)``.

    ``how`` is ``"as is"`` (lanes, a model axis of size 1, or no hint: the
    leaf is whole here), ``"whole"`` (a hinted leaf that :func:`leaf_cut`
    makes one row, ``cut.ax`` None: gathered over the model axis and run
    whole on every shard) or ``"rows"`` (the rank's block of the leaf's
    rows).  ``cut`` is the whole leaf's, with the rank's ``S`` under
    ``"rows"``."""
    shape = tuple(int(d) for d in shape)
    if ax is None or model is None or model.lanes or model.size == 1:
        return "as is", leaf_cut(shape, ax, cfg, n_workers)
    full = shape[:ax] + (shape[ax] * model.size,) + shape[ax + 1:]
    cut = leaf_cut(full, ax, cfg, n_workers)
    if cut.ax is None:
        return "whole", cut
    return "rows", cut._replace(S=cut.S // model.size)


def _gather_model(x, dim, model):
    """The model shards' pieces of ``x`` concatenated along ``dim``."""
    return torch.cat(list(model.all_gather(x)), dim)


def _own(x, dim, model):
    """This rank's piece of a whole tensor along ``dim``."""
    return x.chunk(model.size, dim)[model.rank]


def _no_quantize(vals):
    return vals


def _rows_quantizer(spec, model, recorder):
    """(the spec to select with, the quantization of the selected rows) for
    a rank's rows: the values of every shard's rows are quantized together,
    with ONE scale over the whole leaf's rows, as the reference's (and this
    rank keeps its rows)."""
    if spec.quantize == "none":
        return spec, _no_quantize

    def quantize(vals):
        with recorder.span("exchange/collective"):
            vals = _gather_model(vals, 0, model)
        whole = engine_lib._maybe_quantize_rows(vals, spec.quantize)
        return _own(whole, 0, model)

    return dataclasses.replace(spec, quantize="none"), quantize


def _each_leaf(run, state, grads, *held, cfg, lr, mesh, shard_axes,
               recorder):
    """Every leaf of a sparse exchange under :func:`model_axis_rule`, run
    by the mode's leaf function ``run(u, g, *h, cut=, ...)``, with ``h``
    the leaf's leaves of the trees ``held`` (shardedps' M and v); ``run``
    writes the new state into them and returns (update, *rest).  Returns
    the velocity's tree paths and, per leaf, (how, update, *rest)."""
    spec, model = cfg.spec(), mesh.model
    u_leaves, paths = tree_flatten(state.velocity)
    if shard_axes is None:
        shard_axes = [None] * len(u_leaves)
    out = []
    for leaf, (u, g, ax, *h) in enumerate(zip(
            u_leaves, tree_leaves(grads), shard_axes,
            *map(tree_leaves, held))):
        how, cut = model_axis_rule(u.shape[1:], ax, cfg, mesh.size, model)
        sel, quantize = (_rows_quantizer(spec, model, recorder)
                         if how == "rows" else (spec, _no_quantize))

        def run_leaf(u, g):
            return run(u, g, *h, cut=cut, cfg=cfg, lr=lr, mesh=mesh,
                       spec=sel, quantize=quantize, recorder=recorder,
                       leaf=leaf)

        if how != "whole":
            out.append((how, *run_leaf(u, g)))
            continue
        with recorder.span("exchange/collective", leaf=leaf):
            uf = _gather_model(u, ax + 1, model)
            gf = _gather_model(g, ax + 1, model)
        up, *rest = run_leaf(uf, gf)
        del gf
        with recorder.span("exchange/layout", leaf=leaf):
            u.copy_(_own(uf, ax + 1, model))
            up = _own(up, ax, model).contiguous()
        out.append((how, up, *rest))
    return paths, out


# ---------------------------------------------------------------------------
# the row layout of both sparse exchanges: the kernels read (S, rest) rows
# of unit stride
# ---------------------------------------------------------------------------

def _rows_in(u_l, g_l, cut):
    """(um, u_rows, g_rows): the lane's velocity ``u_l`` with ``cut.ax``
    first (None: one row), and its and the gradient's ``(S, rest)`` float32
    rows of unit stride (``um``'s own storage where they need no copy)."""
    def rows_of(x):
        return (x.reshape(1, cut.rest) if cut.ax is None
                else x.movedim(cut.ax, 0))

    um = rows_of(u_l)
    u_rows = um.reshape(cut.S, cut.rest).contiguous()
    g_rows = (rows_of(g_l).reshape(cut.S, cut.rest).to(torch.float32)
              .contiguous())
    return um, u_rows, g_rows


def _rows_back(um, u_new):
    """The new velocity ``(S, rest)`` written into ``um``; nothing to do
    where ``u_new`` is already ``um``'s storage."""
    if u_new.data_ptr() != um.data_ptr():
        um.copy_(u_new.view(um.shape))


def _by_row(x):
    """Gathered ``(..., W, S, k)`` as ``(-1, W*k)`` rows: row s holds
    worker 0's k entries of it, then worker 1's, ... (the update order)."""
    return x.transpose(-3, -2).reshape(-1, x.shape[-3] * x.shape[-1])


def _gather_rows(vals, idx, mesh, recorder, leaf):
    """The lanes' ``(S, k)`` messages stacked, gathered over the mesh and
    read as ``(S, W*k)`` rows: (float32 values, indices)."""
    with recorder.span("exchange/layout", leaf=leaf):
        vals, idx = torch.stack(vals), torch.stack(idx)
    with recorder.span("exchange/collective", leaf=leaf):
        gvals = mesh.gather(vals)                            # (W, S, k)
        gidx = mesh.gather(idx)
    with recorder.span("exchange/layout", leaf=leaf):
        return _by_row(gvals).to(torch.float32), _by_row(gidx)


def _rows_out(rows, shape, ax):
    """``(S, rest)`` rows back in the leaf's ``shape`` (``ax`` moved back;
    None: the leaf was one row)."""
    if ax is None:
        return rows.reshape(shape)
    moved = (shape[ax],) + shape[:ax] + shape[ax + 1:]
    return rows.reshape(moved).movedim(0, ax)


# ---------------------------------------------------------------------------
# dense (all-reduce) baseline
# ---------------------------------------------------------------------------

def dense_momentum_exchange(state, grads, *, cfg, lr, mesh,
                            recorder=NULL):
    """Classic DP baseline: the workers' mean gradient, heavy-ball
    momentum.  The update is the new velocity, the same on every lane."""
    u_leaves, paths = tree_flatten(state.velocity)
    upd = []
    for leaf, (u, g) in enumerate(zip(u_leaves, tree_leaves(grads))):
        with recorder.span("exchange/collective", leaf=leaf):
            g_mean = mesh.mean(g.to(torch.float32))
        for lane in range(u.shape[0]):
            u[lane] = engine_lib.velocity_accumulate(
                u[lane], g_mean, momentum=cfg.momentum, lr=lr)
        upd.append(u[0].clone())
    return tree_unflatten(paths, upd), state


# ---------------------------------------------------------------------------
# allgather sparse exchange (paper-faithful)
#
# A leaf with a shard hint selects along its unsharded dims, per slice of
# the hinted one: the reference keeps every step of the selection local to
# a model shard that way.  Per-slice thresholds are a structured variant of
# the paper's per-tensor threshold.
# ---------------------------------------------------------------------------

def _leaf_allgather_hinted(u, g, *, cut, cfg, lr, mesh, spec, quantize,
                           recorder, leaf):
    """SAMomentum + top-k + sparse all-gather for one leaf, ``u`` and ``g``
    ``(L, *shape)``, cut as ``cut`` (:func:`leaf_cut`).  Each lane runs the
    reference's per-device steps on its worker's tensor (so the transients
    are one worker's); the lanes' messages are stacked for the collective.
    Writes the new velocity into ``u``; returns a 1-tuple, the update to
    subtract (``shape``).  ``recorder`` records the phases as spans of leaf
    ``leaf``."""
    from repro_torch.kernels import ops

    L, shape = u.shape[0], tuple(u.shape[1:])
    W = mesh.size
    span = recorder.span
    if cut.flat:
        vals, idx = [], []
        for lane in range(L):
            with span("exchange/select", leaf=leaf, lane=lane):
                msg, u_new = engine_lib.samomentum_step(
                    u[lane], g[lane].to(torch.float32),
                    momentum=cfg.momentum, lr=lr, k=cut.k_row, spec=spec)
            with span("exchange/layout", leaf=leaf, lane=lane):
                u[lane] = u_new
            vals.append(msg.values)
            idx.append(msg.indices)
        with span("exchange/layout", leaf=leaf):
            vals, idx = torch.stack(vals), torch.stack(idx)
        with span("exchange/collective", leaf=leaf):
            gvals = mesh.gather(vals)                        # (W, k)
            gidx = mesh.gather(idx)
        with span("exchange/scatter", leaf=leaf):
            dense = torch.zeros(cut.rest, dtype=torch.float32,
                                device=u.device)
            ops.scatter_add(dense, gidx.reshape(-1), gvals.reshape(-1))
            return ((dense * rcp(W)).view(shape),)
    wdt = _wire(cfg.wire_dtype)
    vals, idx = [], []
    for lane in range(L):
        with span("exchange/layout", leaf=leaf, lane=lane):
            um, u_rows, g_rows = _rows_in(u[lane], g[lane], cut)
        with span("exchange/select", leaf=leaf, lane=lane):
            # the new velocity over u_rows: where those rows are u's own
            # storage (dim 0 hinted, as an embedding), in place
            v_l, i_l, u_new = engine_lib.samomentum_step_rows(
                u_rows, g_rows, momentum=cfg.momentum, lr=lr, k=cut.k_row,
                spec=spec, out=u_rows)
            del g_rows
            v_l = quantize(v_l)
        with span("exchange/layout", leaf=leaf, lane=lane):
            _rows_back(um, u_new)
            del u_rows, u_new
            vals.append(v_l.to(wdt))
        idx.append(i_l)
    gv, gi = _gather_rows(vals, idx, mesh, recorder, leaf)
    with span("exchange/scatter", leaf=leaf):
        dense = torch.zeros((cut.S, cut.rest), dtype=torch.float32,
                            device=u.device)
        ops.scatter_add_rows(dense, None, gi, gv)
        return (_rows_out(dense * rcp(W), shape, cut.ax),)


def allgather_exchange(state, grads, *, cfg, lr, mesh, shard_axes=None,
                       recorder=NULL):
    """Per-leaf: SAMomentum -> top-k -> all-gather sparse -> scatter.

    Returns (updates, state): ``updates`` is the mean lr-scaled update to
    subtract from the (replicated) parameters.  ``shard_axes`` is an
    optional per-leaf list of hinted dim indices (see above).
    """
    paths, out = _each_leaf(_leaf_allgather_hinted, state, grads, cfg=cfg,
                            lr=lr, mesh=mesh, shard_axes=shard_axes,
                            recorder=recorder)
    return tree_unflatten(paths, [up for _, up in out]), state


# ---------------------------------------------------------------------------
# sharded-PS all_to_all exchange (dual-way DGS)
# ---------------------------------------------------------------------------

def rows_view(shape, shard_axis):
    """(S, rest, ax) row view used by the hinted exchanges and their state
    shapes.  shard_axis None -> single row (per-tensor selection)."""
    size = 1
    for d in shape:
        size *= int(d)
    if shard_axis is None or len(shape) <= 1:
        return 1, size, None
    dims = [int(d) for d in shape]
    lead = dims.pop(shard_axis)
    rows, rest = lead, size // lead
    while dims and rest > (1 << 22) and len(dims) > 1:
        rows *= dims.pop(0)
        rest = 1
        for d in dims:
            rest *= d
    return rows, rest, shard_axis


class LeafCut(NamedTuple):
    """How a sparse exchange cuts one leaf: ``flat`` (allgather's flat
    branch, one selection over the whole leaf) or ``S`` rows of ``rest``
    with the dim ``ax`` moved first (None: the leaf reshaped to one row),
    ``k_row`` entries selected per row, and in shardedps the owner-bucket
    ``cap``, the owner's ``shard_rest`` columns and the downward ``k2``
    per row (0 in allgather)."""

    flat: bool
    S: int
    rest: int
    ax: int | None
    k_row: int
    cap: int = 0
    shard_rest: int = 0
    k2: int = 0


def leaf_cut(shape, shard_axis, cfg: ExchangeConfig,
             n_workers: int) -> LeafCut:
    """The cut of one leaf of ``shape`` in ``cfg.mode`` (allgather or
    shardedps) over ``n_workers`` workers; the leaf's k is
    ``density_to_k`` of the whole (stacked) leaf."""
    shape = tuple(int(d) for d in shape)
    size = 1
    for d in shape:
        size *= d
    k = density_to_k(size, cfg.density)
    W = n_workers
    if cfg.mode == "allgather":
        if (shard_axis is None or len(shape) == 1) and size < (1 << 24):
            return LeafCut(True, 1, size, None, k)
        # the hinted dim first (dim 0 without a hint), then fold further
        # leading dims until each row is small enough for a cheap per-row
        # top-k; a large 1-D leaf is one entry a row
        ax = shard_axis if shard_axis is not None else 0
        S, rest = (size, 1) if len(shape) == 1 else rows_view(shape, ax)[:2]
        return LeafCut(False, S, rest, ax, max(1, min(rest, -(-k // S))))
    if cfg.mode != "shardedps":
        raise ValueError(f"mode {cfg.mode!r} cuts no leaf")
    S, rest, ax = rows_view(shape, shard_axis)
    shard_rest = ShardSpec.even_stride(rest, W)
    k_row = max(1, min(rest, -(-k // S)))
    cap = max(1, int(round(k_row / W * cfg.bucket_factor)))
    k2 = max(1, min(shard_rest,
                    int(round(k_row / W)) if cfg.secondary_density is None
                    else density_to_k(shard_rest, cfg.secondary_density)))
    return LeafCut(False, S, rest, ax, k_row, cap, shard_rest, k2)


def _leaf_shardedps_hinted(u, g, m_sh, v_sh, *, cut, cfg, lr, mesh, spec,
                           quantize, recorder, leaf):
    """Row-wise sharded-PS dual-way exchange for one leaf.

    View: (S, rest) rows per worker.  Worker w owns columns
    [w*shard_rest, (w+1)*shard_rest) of every row (``ShardSpec.even``'s
    partition, the cluster's rule).

    Upward:  per-row top-k entries are bucketed by owner and exchanged with
             ONE all-to-all.
    Server:  each owner scatter-adds into its M shard and tracks v (what it
             has broadcast); the difference M - v accumulates every unsent
             remainder and bucket overflow, as paper Eq. (6).
    Down:    top-k2 of the difference shard, all-gathered.

    ``cut`` is the leaf's :func:`leaf_cut`.  Each lane runs its worker's
    steps on its own tensors; the lanes' sends
    are stacked for the collectives.  Writes the new velocity, M and v into
    ``u``, ``m_sh``, ``v_sh``; returns (update, overflow): the ``(L,)``
    int32 count of selected entries dropped at the ``W*cap`` slot this step
    (their mass stays in the velocity).  ``recorder`` records the phases
    as spans of leaf ``leaf``."""
    from repro_torch.kernels import ops

    W, L = mesh.size, u.shape[0]
    shape = tuple(u.shape[1:])
    S, rest, k_row = cut.S, cut.rest, cut.k_row
    shard_rest, cap, k2 = cut.shard_rest, cut.cap, cut.k2
    wdt = _wire(cfg.wire_dtype)
    dev = u.device
    span = recorder.span
    send_v, send_i, ovf = [], [], []
    for lane in range(L):
        with span("exchange/layout", leaf=leaf, lane=lane):
            um, u_rows, g_rows = _rows_in(u[lane], g[lane], cut)
        with span("exchange/select", leaf=leaf, lane=lane):
            uacc = engine_lib.velocity_accumulate(
                u_rows, g_rows, momentum=cfg.momentum, lr=lr)
            del u_rows, g_rows
            vals, idx = engine_lib.select_rows(uacc, k_row, spec)
            vals = quantize(vals)
        with span("exchange/bucket", leaf=leaf, lane=lane):
            # ---- bucket by owner, per row ----
            idx = idx.to(torch.int64)
            order = torch.argsort(idx // shard_rest, dim=1, stable=True)
            idx_s = torch.gather(idx, 1, order)
            vals_s = torch.gather(vals, 1, order)
            owner_s = idx_s // shard_rest
            pos = (torch.arange(k_row, device=dev)[None]
                   - torch.searchsorted(owner_s, owner_s))
            ok = pos < cap
            slot = torch.where(ok, owner_s * cap + pos, W * cap)
            buf_v = torch.zeros((S, W * cap + 1), dtype=torch.float32,
                                device=dev).scatter_(
                1, slot, torch.where(ok, vals_s, 0.0))
            buf_i = torch.full((S, W * cap + 1), -1, dtype=torch.int32,
                               device=dev).scatter_(
                1, slot,
                torch.where(ok, idx_s % shard_rest, -1).to(torch.int32))
            ovf.append((~ok).sum().to(torch.int32))
        with span("exchange/layout", leaf=leaf, lane=lane):
            # (S, W, cap) -> (W, S, cap): the all-to-all's send, by owner
            send_v.append(buf_v[:, :-1].reshape(S, W, cap).transpose(0, 1)
                          .to(wdt))
            send_i.append(buf_i[:, :-1].reshape(S, W, cap).transpose(0, 1))
        with span("exchange/select", leaf=leaf, lane=lane):
            # SAMomentum rescale: only the shipped coordinates keep u
            # (bucket overflow is NOT shipped -- its mass must stay in the
            # velocity)
            shipped = torch.zeros((S, rest + 1), dtype=torch.bool,
                                  device=dev).scatter_(
                1, torch.where(ok, idx_s, rest), True)[:, :-1]
            u_new = engine_lib.samomentum_rescale(uacc, shipped,
                                                  cfg.momentum)
            del uacc, shipped
        with span("exchange/layout", leaf=leaf, lane=lane):
            _rows_back(um, u_new)
            del u_new
    # ---- all-to-all: row i of a lane's receive is what worker i sent ----
    with span("exchange/layout", leaf=leaf):
        send_v, send_i = torch.stack(send_v), torch.stack(send_i)
    with span("exchange/collective", leaf=leaf):
        recv_v = mesh.all_to_all(send_v)
        recv_i = mesh.all_to_all(send_i)                     # (L, W, S, cap)
    del send_v, send_i
    # ---- server shard update: M -= the received, in worker order (an
    # empty slot's -1 is dropped) ----
    with span("exchange/layout", leaf=leaf):
        recv_i = _by_row(recv_i)                             # (L*S, W*cap)
        recv_v = -_by_row(recv_v.to(torch.float32))
    with span("exchange/scatter", leaf=leaf):
        ops.scatter_add_rows(m_sh.view(L * S, shard_rest), None, recv_i,
                             recv_v)
    del recv_v, recv_i
    # ---- downward: secondary-compressed difference shard ----
    me = mesh.index().to(torch.int32) * shard_rest            # (L,)
    dvals, didx = [], []
    for lane in range(L):
        m_l = m_sh[lane].view(S, shard_rest)
        v_l = v_sh[lane].view(S, shard_rest)
        with span("exchange/select", leaf=leaf, lane=lane):
            d_v, d_i = engine_lib.select_rows(m_l - v_l, k2, spec)
            d_v = quantize(d_v)
        with span("exchange/scatter", leaf=leaf, lane=lane):
            ops.scatter_add_rows(v_l, None, d_i, d_v)
        with span("exchange/layout", leaf=leaf, lane=lane):
            dvals.append(d_v.to(wdt))
            didx.append(d_i + me[lane])
    gvals, gidx = _gather_rows(dvals, didx, mesh, recorder, leaf)
    with span("exchange/scatter", leaf=leaf):
        dense = torch.zeros((S, W * shard_rest), dtype=torch.float32,
                            device=dev)
        ops.scatter_add_rows(dense, None, gidx, gvals)
        upd = dense[:, :rest].neg_().mul_(rcp(W))
    with span("exchange/bucket", leaf=leaf):
        ovf = torch.stack(ovf)
    with span("exchange/layout", leaf=leaf):
        return _rows_out(upd, shape, cut.ax), ovf


def shardedps_exchange(state, grads, *, cfg, lr, mesh, shard_axes=None,
                       recorder=NULL):
    """Dual-way sparse exchange against a parameter server sharded over the
    workers: per-leaf dispatch to the row-wise implementation above.  On a
    rank of the model axis the overflow counts every shard's rows, as the
    reference's count spans the whole leaf."""
    paths, out = _each_leaf(_leaf_shardedps_hinted, state, grads,
                            state.m_shard, state.v_shard, cfg=cfg, lr=lr,
                            mesh=mesh, shard_axes=shard_axes,
                            recorder=recorder)
    step_ovf = sum(ovf for how, _, ovf in out if how != "rows")
    rows_ovf = [ovf for how, _, ovf in out if how == "rows"]
    if rows_ovf:   # every shard's rows counted
        with recorder.span("exchange/collective"):
            rows_ovf = mesh.model.all_gather(sum(rows_ovf))
        step_ovf = step_ovf + rows_ovf.sum(0).to(torch.int32)
    overflow = state.overflow
    if isinstance(overflow, torch.Tensor):
        overflow += step_ovf
    else:   # a state built without buckets: start at zero
        overflow = step_ovf
    return (tree_unflatten(paths, [up for _, up, _ in out]),
            state._replace(overflow=overflow))


# ---------------------------------------------------------------------------
# mesh-shard route exchange: the mesh server's stage
# ---------------------------------------------------------------------------

def shard_exchange_batch(spec: ShardSpec, indices, values, *,
                         cap: int | None = None,
                         use_mesh: bool | None = None, mesh=None):
    """Route a batch of global-index sparse messages to shard-local slots.

    ``indices``/``values``: ``(B, k)``, int32 global arena indices (``-1``
    = padding).  Each message is cut into ``S`` even source chunks of
    ``kp = ShardSpec.even_stride(k, S)``, each chunk is bucketed by
    ``kernels.ops.route_by_shard_batch`` (row 1 places the values), and
    the ``(source, destination)`` buckets are swapped.  On one card
    (``use_mesh`` false, the default without a ``mesh``) every chunk is
    routed there and the buckets permuted ``(src, dst) -> (dst, src)``,
    the reference's own one-device leg.  With ``use_mesh`` (the default
    when ``mesh`` is given) ``mesh`` is the
    :class:`~repro_torch.launch.mesh.ProcessMesh` of the S shards' ranks:
    rank r routes source chunk r and the buckets cross with one
    ``all_to_all_single``; every rank then gathers the others' slices, so
    it returns the same global arrays as the one-card leg.

    ``cap`` bounds the entries per (source chunk, destination shard) pair
    and defaults to ``kp``: a chunk holds only ``kp`` entries, so the
    default never overflows.

    Returns ``(local_idx, vals, overflow)``: ``(B, S, S*cap)`` shard-local
    indices (``-1`` = empty slot) and values, and the int64 count of
    entries dropped by ``cap`` (a scalar on the device).
    """
    from repro_torch.kernels import ops

    S = spec.n_shards
    B, k = indices.shape
    kp = ShardSpec.even_stride(k, S)
    cap = int(cap) if cap is not None else kp
    pad = S * kp - k
    idx3 = torch.nn.functional.pad(indices.to(torch.int32), (0, pad),
                                   value=-1).reshape(B, S, kp)
    val3 = torch.nn.functional.pad(values, (0, pad)).reshape(B, S, kp)
    if use_mesh is None:
        use_mesh = mesh is not None
    if use_mesh:
        if getattr(mesh, "rank", None) is None or mesh.size != S:
            raise ValueError(f"use_mesh=True needs mesh=, the ProcessMesh "
                             f"of the {S} shards' ranks")
        # this rank's source chunk of every message -> (B, S_dst, cap)
        ri_c, rv_c, ovf = ops.route_by_shard_batch(
            idx3[:, mesh.rank].contiguous(), val3[:, mesh.rank].contiguous(),
            bounds=spec.bounds, n_shards=S, cap=cap)
        recv_i = mesh.all_to_all(ri_c.transpose(0, 1)[None])[0]  # (S_src,B,cap)
        recv_v = mesh.all_to_all(rv_c.transpose(0, 1)[None])[0]
        ri = recv_i.transpose(0, 1).reshape(1, B, S * cap)
        rv = recv_v.transpose(0, 1).reshape(1, B, S * cap)
        return (mesh.gather(ri).transpose(0, 1).contiguous(),
                mesh.gather(rv).transpose(0, 1).contiguous(),
                mesh.gather(ovf.reshape(1)).sum())
    ri, rv, ovf = ops.route_by_shard_batch(
        idx3.reshape(B * S, kp), val3.reshape(B * S, kp), bounds=spec.bounds,
        n_shards=S, cap=cap)
    ri = ri.view(B, S, S, cap).transpose(1, 2).reshape(B, S, S * cap)
    rv = rv.view(B, S, S, cap).transpose(1, 2).reshape(B, S, S * cap)
    return ri, rv, ovf


# ---------------------------------------------------------------------------
# unified entry point
# ---------------------------------------------------------------------------

def exchange(state, grads, *, cfg: ExchangeConfig, lr, mesh,
             shard_axes=None, recorder=NULL):
    """One exchange step of every worker of ``mesh``: ``grads`` and the
    state's leaves carry the mesh's lane dim.  Returns (updates, state).
    ``recorder`` records the phases as spans (module docstring)."""
    if cfg.mode == "dense":
        return dense_momentum_exchange(state, grads, cfg=cfg, lr=lr,
                                       mesh=mesh, recorder=recorder)
    if cfg.mode == "allgather":
        return allgather_exchange(state, grads, cfg=cfg, lr=lr, mesh=mesh,
                                  shard_axes=shard_axes, recorder=recorder)
    if cfg.mode == "shardedps":
        return shardedps_exchange(state, grads, cfg=cfg, lr=lr, mesh=mesh,
                                  shard_axes=shard_axes, recorder=recorder)
    raise ValueError(f"unknown exchange mode {cfg.mode!r}")
