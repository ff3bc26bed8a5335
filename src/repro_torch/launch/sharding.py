"""Sharding rules: the per-leaf partition of the parameters over the
``"model"`` mesh axis, and of the batch and the decode caches over the data
axes (PyTorch port of ``repro.launch.sharding``).

A spec is a tuple with one entry per dim: ``"model"``, the data axes
(one name, or a tuple of names), or None, as the reference's
``PartitionSpec`` reads.  At model size M a ``"model"`` dim holds M even
pieces, piece m on model shard m (:func:`shard_leaf`); the rules also
decide the exchange's per-leaf hints.  Rules are name+shape based so one
function serves all 10 architectures:

* attn/MLP in-projections  (d, H*hd|ff)  -> (None, "model")
* out/down projections     (ff|H*hd, d)  -> ("model", None)
* MoE expert tensors       (E, d, f)     -> ("model", None, None)  (EP)
* embeddings               (V, d)        -> ("model", None)
* vectors/norms            (d,)          -> replicated
* stacked unit params get a leading None.

``shard_axis_hints`` returns, per parameter leaf, the index of the dim
sharded over "model" (or None).  The DGS exchange selects along the
*unsharded* dims only, per slice of the hinted one, so each model shard
selects on its own rows.  At ``model_size`` 1 every weight, bias and
embedding gets a hint; only the norm scales do not.
"""
from __future__ import annotations

import torch

from repro_torch.core.paramspace import tree_flatten, tree_unflatten
from repro_torch.models.config import ModelConfig

# names of projection params whose LAST dim shards over model
_COL_SHARDED = {"wq", "wk", "wv", "up", "gate", "wq_b", "wkv_b", "in_proj"}
# names whose FIRST dim shards over model
_ROW_SHARDED = {"wo", "down", "out_proj"}


def _leaf_rule(path_keys: tuple[str, ...], shape: tuple[int, ...],
               model_size: int, n_kv_heads: int = 0) -> tuple:
    """The spec of one (possibly unit-stacked) parameter leaf: a tuple of
    axis names (``"model"`` or None), one per dim."""
    names = [k for k in path_keys]
    stacked = names and names[0] == "units"

    def wrap(spec_dims):
        if stacked:
            return tuple([None] + spec_dims)
        return tuple(spec_dims)

    core = shape[1:] if stacked else shape
    nd = len(core)
    owner = None
    for n in reversed(names):
        if n in ("w", "b", "scale", "bias", "table", "conv_w", "conv_b",
                 "A_log", "dt_bias", "D"):
            continue
        owner = n
        break
    last = names[-1]

    def ok(dim_idx):
        return core[dim_idx] % model_size == 0 and core[dim_idx] >= model_size

    # MoE expert tensors: (E, d, f) / (E, f, d): expert parallelism on dim 0
    if "moe" in names and last in ("up", "gate", "down") and nd == 3:
        if ok(0):
            return wrap(["model", None, None])
        return wrap([None] * nd)
    if last == "table" and nd == 2:          # embedding (V, d)
        if ok(0):
            return wrap(["model", None])     # vocab-parallel
        if ok(1):
            return wrap([None, "model"])
        return wrap([None, None])
    if last in ("w", "b") and owner in ("wk", "wv"):
        # K/V projections: shard only when whole KV heads land on each model
        # shard.  If n_kv_heads < model_size the shards would cut through
        # head_dim, and RoPE's strided slices on the fractured dim crash
        # XLA's SPMD gather partitioner (observed on every kv<16 arch).
        if n_kv_heads % model_size == 0 and ok(nd - 1):
            return wrap([None] * (nd - 1) + ["model"])
        return wrap([None] * nd)
    if last == "w" and owner in _COL_SHARDED and nd == 2:
        return wrap([None, "model"] if ok(1) else [None, None])
    if last == "b" and owner in _COL_SHARDED and nd == 1:
        return wrap(["model"] if ok(0) else [None])
    if last == "w" and owner in _ROW_SHARDED and nd == 2:
        return wrap(["model", None] if ok(0) else [None, None])
    if last == "w" and owner == "lm_head" and nd == 2:  # (d, V)
        return wrap([None, "model"] if ok(1) else [None, None])
    if last == "conv_w" and nd == 2:         # (K, conv_dim)
        return wrap([None, "model"] if ok(1) else [None, None])
    if last in ("conv_b",) and nd == 1:
        return wrap(["model"] if ok(0) else [None])
    if last in ("A_log", "dt_bias", "D") and nd == 1:
        return wrap(["model"] if ok(0) else [None])
    if owner == "router":
        return wrap([None] * nd)
    # norms / small vectors / anything else: replicated
    return wrap([None] * nd)


def param_specs(cfg: ModelConfig, params_shape, model_size: int):
    """Tree of specs matching ``params_shape`` (any leaves with a
    ``.shape``: tensors, meta tensors)."""
    leaves, paths = tree_flatten(params_shape)
    specs = [_leaf_rule(path, tuple(leaf.shape), model_size,
                        n_kv_heads=cfg.n_kv_heads)
             for path, leaf in zip(paths, leaves)]
    return tree_unflatten(paths, specs)


def shard_axis_hints(cfg: ModelConfig, params_shape, model_size: int):
    """Per-leaf index of the model-sharded dim (None if replicated), in
    the tree's leaf order."""
    leaves, paths = tree_flatten(params_shape)
    hints = []
    for path, leaf in zip(paths, leaves):
        spec = _leaf_rule(path, tuple(leaf.shape), model_size,
                          n_kv_heads=cfg.n_kv_heads)
        hints.append(spec.index("model") if "model" in spec else None)
    return hints


def shard_leaf(full, spec, m: int, M: int):
    """Model shard ``m`` of ``M`` of a leaf under its spec: the leaf itself
    when replicated, else its m-th even piece along the ``"model"`` dim (a
    view; numpy arrays and tensors alike)."""
    if M == 1 or "model" not in spec:
        return full
    ax = spec.index("model")
    c = full.shape[ax] // M
    index = (slice(None),) * ax + (slice(m * c, (m + 1) * c),)
    return full[index]


def unshard_leaf(shards, spec):
    """The whole leaf from its M shards (``shard_leaf``'s inverse)."""
    if len(shards) == 1 or "model" not in spec:
        return shards[0]
    return torch.cat(list(shards), spec.index("model"))


def shard_params(params, specs, m: int, M: int):
    """Model shard ``m`` of a parameter tree: each ``"model"`` leaf's
    piece copied into storage of its own (so the whole leaf can go),
    replicated leaves as they are."""
    leaves, paths = tree_flatten(params)
    spec_leaves = tree_flatten(specs)[0]
    return tree_unflatten(paths, [
        leaf if "model" not in spec or M == 1
        else shard_leaf(leaf, spec, m, M).clone(
            memory_format=torch.contiguous_format)
        for leaf, spec in zip(leaves, spec_leaves)])


def _axes(data_axes):
    """One data axis name alone, as ``PartitionSpec`` normalizes it."""
    if isinstance(data_axes, tuple) and len(data_axes) == 1:
        return data_axes[0]
    return data_axes


def _map_leaves(rule, tree):
    """``rule(shape)`` at every ``(shape, dtype)`` leaf of a tree of dicts
    and named tuples (the caches' ``KVCache``), as ``input_specs`` makes
    them; the tree's structure kept."""
    if isinstance(tree, dict):
        return {key: _map_leaves(rule, val) for key, val in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(rule, val) for val in tree))
    return rule(tuple(tree[0]))


def batch_specs(cfg: ModelConfig, batch_shape, data_axes):
    """Shard every batch input along its leading (batch) dim."""
    axes = _axes(data_axes)
    return _map_leaves(
        lambda shape: (axes,) + (None,) * (len(shape) - 1) if shape else (),
        batch_shape)


def cache_specs(cfg: ModelConfig, caches_shape, data_axes, model_size: int,
                *, batch: int, n_data: int):
    """Decode caches: (n_units, B, L, heads..., hd).

    Shard batch over the data axes when divisible; otherwise (long_500k,
    B=1) shard the cache length.  Shard the heads (or head_dim / state)
    over "model" when divisible.
    """
    axes = _axes(data_axes)
    shard_batch = batch % n_data == 0 and batch >= n_data

    def rule(shape):
        dims: list = [None] * len(shape)
        if len(shape) >= 2:
            if shard_batch:
                dims[1] = axes
            elif len(shape) >= 3 and shape[2] % n_data == 0:
                dims[2] = axes  # shard cache length / conv dim
        # model axis: try trailing dims from the end (hd, heads, state)
        for i in range(len(shape) - 1, 2, -1):
            if shape[i] % model_size == 0 and shape[i] >= model_size:
                dims[i] = "model"
                break
        return tuple(dims)

    return _map_leaves(rule, caches_shape)
