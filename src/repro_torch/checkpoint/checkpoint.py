"""Pytree checkpointing: flat-path ``.npz`` plus ``.meta.json``, restore in
place (PyTorch port of ``repro.checkpoint.checkpoint``).

A tree is nested dicts, lists and tuples of tensors.  Its flat keys are
the reference's: a dict key is ``str(key)``, a sequence item ``[i]``,
joined by ``//``; dict keys are visited sorted, as ``jax.tree_util``
visits them.  So an ``.npz`` that one package writes loads in the other.
bf16 leaves are stored widened to float32 (numpy has no bf16) and cast back
to the target's dtype on restore.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

_SEP = "//"


def _children(node):
    """``(path element, child)`` pairs of an inner node, or None for a
    leaf."""
    if isinstance(node, dict):
        return [(str(key), node[key]) for key in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", child) for i, child in enumerate(node)]
    return None


def _flatten_with_paths(tree, prefix=()):
    """``[(key, leaf), ...]`` in the reference's leaf order."""
    children = _children(tree)
    if children is None:
        return [(_SEP.join(prefix), tree)]
    out = []
    for name, child in children:
        out += _flatten_with_paths(child, prefix + (name,))
    return out


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    children = _children(like)
    if children is None:
        return next(leaves)
    if isinstance(like, dict):
        return {key: _rebuild(like[key], leaves) for key in sorted(like)}
    return type(like)(_rebuild(child, leaves) for child in like)


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A leaf as a host array; bf16 widened to float32."""
    leaf = leaf.detach()
    if leaf.dtype == torch.bfloat16:
        leaf = leaf.to(torch.float32)
    return leaf.cpu().numpy()


def save_checkpoint(path: str, tree, *, step: int = 0,
                    extra: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {key: _host(leaf) for key, leaf in _flatten_with_paths(tree)}
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)
    meta = {"step": step, "keys": sorted(arrays), "extra": extra or {}}
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f, indent=1)


def load_checkpoint(path: str, like):
    """Restore into the structure of ``like`` (its keys and shapes are
    checked; each leaf takes ``like``'s dtype and device).  Returns
    ``(tree, meta)``."""
    npz = np.load(path if path.endswith(".npz") else path + ".npz")
    flat = _flatten_with_paths(like)
    keys = {key for key, _ in flat}
    missing = keys - set(npz.files)
    extra = set(npz.files) - keys
    if missing or extra:
        raise ValueError(
            f"checkpoint structure mismatch: missing={sorted(missing)[:5]} "
            f"extra={sorted(extra)[:5]}")
    leaves = []
    for key, leaf in flat:
        arr = npz[key]
        shape = tuple(leaf.shape)
        if arr.shape != shape:
            raise ValueError(f"shape mismatch at {key}: "
                             f"{arr.shape} vs {shape}")
        leaves.append(torch.from_numpy(arr).to(device=leaf.device,
                                               dtype=leaf.dtype))
    with open(_meta_path(path)) as f:
        meta = json.load(f)
    return _rebuild(like, iter(leaves)), meta


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"
