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
