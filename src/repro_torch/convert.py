"""Carries weights across from the JAX package.

The reference's parameters, taken to the host (``jax.device_get``), are a
nested dict of numpy arrays; :func:`params_from_numpy` makes the port's
dict of tensors from them, keys sorted at every level, which is the leaf
order of both packages' arenas.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_numpy(tree, device=None):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (None = the card, as every entry point of the port; same values, same
    dtypes, sorted keys)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {key: params_from_numpy(tree[key], device)
                for key in sorted(tree)}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def shard_params_from_numpy(tree, cfg, m: int, M: int, device=None):
    """Model shard ``m`` of ``M`` of the reference's numpy parameters, on
    ``device``: each leaf of a ``"model"`` spec (``launch.sharding.
    param_specs`` at model size M) cut to its piece on the host, so the
    whole leaf never reaches the device."""
    from repro_torch.core.paramspace import tree_flatten, tree_unflatten
    from repro_torch.launch.sharding import param_specs, shard_leaf

    leaves, paths = tree_flatten(tree)
    specs = tree_flatten(param_specs(cfg, tree, M))[0]
    return params_from_numpy(tree_unflatten(paths, [
        shard_leaf(np.asarray(leaf), spec, m, M)
        for leaf, spec in zip(leaves, specs)]), device)
