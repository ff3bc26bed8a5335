"""The flat parameter arena (PyTorch port of ``repro.core.paramspace``,
:class:`ParamSpace` only).

A parameter tree is a nested dict of tensors.  Its leaf order is the
reference's ``jax.tree.leaves`` order, which SORTS dict keys at every level:
``{"w1", "b1", "w2", "b2"}`` packs as ``b1, b2, w1, w2``.  Every global
arena index depends on that order, so :func:`tree_leaves` sorts the same way.
"""
from __future__ import annotations

import dataclasses

import torch

from . import engine as engine_lib
from .engine import CompressionSpec
from .sparsify import SparseLeaf, density_to_k, quantize_rows


def tree_flatten(tree) -> tuple[list, tuple]:
    """(leaves, paths) of a nested dict, keys sorted at every level."""
    leaves, paths = [], []

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (key,))
        else:
            leaves.append(node)
            paths.append(path)

    walk(tree, ())
    return leaves, tuple(paths)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_unflatten(paths, leaves):
    """Inverse of :func:`tree_flatten`."""
    if paths == ((),):
        return leaves[0]
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


@dataclasses.dataclass(frozen=True)
class ParamSpace:
    """Static descriptor of a parameter tree packed into one f32 arena."""

    paths: tuple[tuple, ...]             # per-leaf key paths (the treedef)
    shapes: tuple[tuple[int, ...], ...]  # per-leaf original shapes
    dtypes: tuple[torch.dtype, ...]      # per-leaf original dtypes
    sizes: tuple[int, ...]               # per-leaf element counts
    offsets: tuple[int, ...]             # per-leaf start offsets
    total: int                           # arena length == sum(sizes)

    @classmethod
    def from_tree(cls, tree) -> "ParamSpace":
        leaves, paths = tree_flatten(tree)
        shapes = tuple(tuple(int(d) for d in l.shape) for l in leaves)
        sizes = tuple(int(l.numel()) for l in leaves)
        offsets, off = [], 0
        for s in sizes:
            offsets.append(off)
            off += s
        return cls(paths=paths, shapes=shapes,
                   dtypes=tuple(l.dtype for l in leaves), sizes=sizes,
                   offsets=tuple(offsets), total=off)

    @property
    def n_leaves(self) -> int:
        return len(self.sizes)

    def ks(self, density: float) -> tuple[int, ...]:
        """Per-leaf top-k counts for a density -- doubles as the message
        segmentation ``seg``."""
        return tuple(density_to_k(s, density) for s in self.sizes)

    def views(self, flat: torch.Tensor) -> list:
        """Per-leaf flat views of the arena (zero-copy slices)."""
        return [flat[off:off + size]
                for off, size in zip(self.offsets, self.sizes)]

    def pack(self, tree) -> torch.Tensor:
        """Tree -> one contiguous ``(total,)`` f32 arena (a new tensor)."""
        return torch.cat([l.reshape(-1).to(torch.float32)
                          for l in tree_leaves(tree)])

    def unpack(self, flat: torch.Tensor):
        """Arena -> tree with the original shapes and dtypes (views of the
        arena where the dtype is already f32)."""
        out = [v.reshape(shape).to(dtype)
               for v, shape, dtype in zip(self.views(flat), self.shapes,
                                          self.dtypes)]
        return tree_unflatten(self.paths, out)

    def select(self, x: torch.Tensor, ks, spec: CompressionSpec
               = engine_lib.DEFAULT_SPEC) -> SparseLeaf:
        """Per-tensor top-k of an arena vector, rebased to global indices
        (``global_index = leaf_offset + local_index``): :meth:`select_rows`
        at B = 1."""
        return self.select_rows(x[None], ks, spec).row(0)

    def select_rows(self, x2d: torch.Tensor, ks, spec: CompressionSpec
                    = engine_lib.DEFAULT_SPEC) -> SparseLeaf:
        """:meth:`select` of each row of a ``(B, total)`` batch, one engine
        call per tensor for all rows: a global-index SparseLeaf with
        ``(B, sum(ks))`` values and indices.  ``spec.quantize`` scales each
        row's segment on its own."""
        vals, idxs = [], []
        for off, size, k in zip(self.offsets, self.sizes, ks):
            eng = engine_lib.resolve_engine(spec, size)
            v, i = eng.select_rows(x2d[:, off:off + size], k)
            vals.append(quantize_rows(v, spec.quantize)[2].to(v.dtype))
            idxs.append(i + off)
        return SparseLeaf(values=torch.cat(vals, dim=1),
                          indices=torch.cat(idxs, dim=1), size=self.total)

    def split(self, msg, seg=None) -> list:
        """Arena message -> per-leaf list (local indices).  Dense arena
        vectors split into per-leaf flat views."""
        if not isinstance(msg, SparseLeaf):
            return self.views(msg)
        if seg is None:
            raise ValueError("splitting a sparse arena message needs seg=")
        out, pos = [], 0
        for off, size, k in zip(self.offsets, self.sizes, seg):
            out.append(SparseLeaf(values=msg.values[pos:pos + k],
                                  indices=msg.indices[pos:pos + k] - off,
                                  size=size))
            pos += k
        return out
