"""The flat parameter arena and its range partition into shards (PyTorch
port of ``repro.core.paramspace``).

A parameter tree is a nested dict of tensors.  Its leaf order is the
reference's ``jax.tree.leaves`` order, which SORTS dict keys at every level:
``{"w1", "b1", "w2", "b2"}`` packs as ``b1, b2, w1, w2``.  Every global
arena index depends on that order, so :func:`tree_leaves` sorts the same way.

:class:`ShardSpec` cuts the arena's index space ``[0, total)`` into ``S``
contiguous shards (the sharded parameter server).  It is host-side index
math, a copy of the reference's; a shard's own parameters are the sub-tree
of the leaves it owns (:func:`subtree`), which flattens in the same order.
An empty shard is a legal space of zero elements.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import engine as engine_lib
from .engine import CompressionSpec
from .sparsify import SparseLeaf, density_to_k, quantize_rows


def _walk(node, path, leaves: list, paths: list) -> None:
    if isinstance(node, dict):
        for key in sorted(node):
            _walk(node[key], path + (key,), leaves, paths)
    else:
        leaves.append(node)
        paths.append(path)


def tree_flatten(tree) -> tuple[list, tuple]:
    """(leaves, paths) of a nested dict, keys sorted at every level.  (A
    recursive closure here would be a reference cycle holding the leaves
    until the garbage collector runs: gigabytes of device memory at full
    width.)"""
    leaves, paths = [], []
    _walk(tree, (), leaves, paths)
    return leaves, tuple(paths)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def subtree(tree, lo: int, hi: int):
    """The sub-tree of ``tree``'s leaves ``lo:hi`` (in flattening order),
    with their key paths: it flattens to exactly those leaves, in order.
    An empty range gives ``{}``."""
    leaves, paths = tree_flatten(tree)
    if lo >= hi:
        return {}
    return tree_unflatten(paths[lo:hi], leaves[lo:hi])


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
        """Tree -> one contiguous ``(total,)`` f32 arena (a new tensor); an
        empty tree (an empty shard) packs to a ``(0,)`` arena on the CPU."""
        leaves = tree_leaves(tree)
        if not leaves:
            return torch.zeros(0, dtype=torch.float32)
        return torch.cat([l.reshape(-1).to(torch.float32) for l in leaves])

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
        row's segment on its own.  An empty space selects nothing."""
        if not self.sizes:
            B = x2d.shape[0]
            return SparseLeaf(
                values=x2d.new_zeros((B, 0)),
                indices=torch.zeros((B, 0), dtype=torch.int32,
                                    device=x2d.device), size=self.total)
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


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Range partition of the arena index space ``[0, total)`` into ``S``
    contiguous shards.

    ``bounds`` has ``S + 1`` ascending entries with ``bounds[0] == 0`` and
    ``bounds[-1] == total``; shard ``s`` owns global indices
    ``[bounds[s], bounds[s+1])`` and rebases them shard-local with ONE
    subtraction: ``local = global - bounds[s]``.  Ranges are disjoint, so
    scatter-adds routed per shard commute bit-exactly with the unsharded
    single-buffer scatter: an ``S``-shard parameter server reproduces the
    single-server run bit for bit.

    ``leaf_splits`` (set by :meth:`for_space`) aligns every boundary to a
    leaf boundary: shard ``s`` owns whole tensors
    ``leaf_splits[s]:leaf_splits[s+1]``, so each shard is itself a valid
    parameter arena, per-tensor selection restricted to a shard is the
    slice of the global selection, and per-segment wire scales are unchanged
    by the split.  The sharded servers require it; :meth:`even` and
    arbitrary ``bounds`` serve the generic :meth:`split_by_shard`.
    """

    bounds: tuple[int, ...]
    leaf_splits: tuple[int, ...] | None = None

    def __post_init__(self):
        b = self.bounds
        if len(b) < 2 or b[0] != 0 or any(x > y for x, y in zip(b, b[1:])):
            raise ValueError(f"bad shard bounds {b}")

    @staticmethod
    def even_stride(total: int, n_shards: int) -> int:
        """The equal-shard stride ``ceil(total / n_shards)``."""
        return -(-int(total) // int(n_shards))

    @classmethod
    def even(cls, total: int, n_shards: int) -> "ShardSpec":
        """Equal contiguous ranges of ``even_stride`` elements (the last
        shard takes the remainder; shards past ``total`` are empty)."""
        stride = cls.even_stride(total, n_shards) if total else 0
        bounds = tuple(min(s * stride, int(total))
                       for s in range(n_shards)) + (int(total),)
        return cls(bounds=bounds)

    @classmethod
    def for_space(cls, space: ParamSpace, n_shards: int) -> "ShardSpec":
        """Leaf-ALIGNED partition balancing element counts greedily:
        boundary ``s`` lands on the leaf edge closest to ``total * s / S``
        (ties to the lower edge, never before the previous boundary).
        Models with fewer leaves than shards get empty shards."""
        edges = tuple(space.offsets) + (space.total,)
        splits = [0]
        for s in range(1, n_shards):
            target = space.total * s / n_shards
            j = min(range(splits[-1], len(edges)),
                    key=lambda j: (abs(edges[j] - target), j),
                    default=splits[-1])
            splits.append(max(j, splits[-1]))
        splits.append(space.n_leaves)
        return cls(bounds=tuple(edges[j] for j in splits),
                   leaf_splits=tuple(splits))

    @property
    def n_shards(self) -> int:
        return len(self.bounds) - 1

    @property
    def total(self) -> int:
        return self.bounds[-1]

    @property
    def sizes(self) -> tuple[int, ...]:
        """Per-shard element counts."""
        return tuple(b - a for a, b in zip(self.bounds, self.bounds[1:]))

    def owner_of(self, indices) -> np.ndarray:
        """Shard id owning each global index (host-side numpy;
        ``searchsorted(bounds, i, right) - 1``, so an empty shard's
        duplicate bound resolves to the shard that is not empty)."""
        return np.searchsorted(np.asarray(self.bounds),
                               np.asarray(indices), side="right") - 1

    def _leaf_range(self, s: int) -> tuple[int, int]:
        if self.leaf_splits is None:
            raise ValueError("this needs a leaf-aligned ShardSpec "
                             "(ShardSpec.for_space)")
        return self.leaf_splits[s], self.leaf_splits[s + 1]

    def shard_leaves(self, leaves: list, s: int) -> list:
        """The leaves shard ``s`` owns (leaf-aligned specs only)."""
        lo, hi = self._leaf_range(s)
        return list(leaves[lo:hi])

    def shard_tree(self, tree, s: int):
        """Shard ``s``'s sub-tree of a parameter tree: its leaves with
        their key paths (leaf-aligned specs only)."""
        return subtree(tree, *self._leaf_range(s))

    def shard_seg(self, seg, s: int) -> tuple[int, ...]:
        """Shard ``s``'s slice of a per-leaf segmentation table
        (leaf-aligned specs only)."""
        lo, hi = self._leaf_range(s)
        return tuple(seg[lo:hi])

    def split_dense(self, x) -> list:
        """Dense ``(total,)`` arena -> per-shard contiguous slices."""
        return [x[a:b] for a, b in zip(self.bounds, self.bounds[1:])]

    def split_by_shard(self, msg, seg=None) -> list:
        """Route one arena message to shards, indices rebased shard-local:
        ``[(piece, sub_seg), ...]``.  A dense arena vector splits into
        contiguous slices (``sub_seg`` None); a global-index SparseLeaf
        into each shard's entries with ``indices - bounds[s]`` and its
        slice of the segment table.

        Leaf-aligned specs with ``seg`` split by static slicing (entries are
        grouped in leaf order).  Arbitrary bounds partition on the host by
        index range, keeping entry order within each shard and splitting a
        straddled segment into per-shard sub-counts.  Values are routed
        verbatim, so the pieces decode bit-equal to the unsharded message.
        """
        if not isinstance(msg, SparseLeaf):
            return [(piece, None) for piece in self.split_dense(msg)]
        if seg is None:
            raise ValueError("splitting a sparse arena message needs seg=")
        if int(msg.size) != self.total:
            raise ValueError(f"message over a {msg.size}-element arena "
                             f"cannot split with bounds ending at "
                             f"{self.total}")
        if self.leaf_splits is not None:
            cut = np.cumsum((0,) + tuple(seg))
            out = []
            for s in range(self.n_shards):
                a = int(cut[self.leaf_splits[s]])
                b = int(cut[self.leaf_splits[s + 1]])
                out.append((SparseLeaf(
                    values=msg.values[a:b],
                    indices=msg.indices[a:b] - self.bounds[s],
                    size=self.bounds[s + 1] - self.bounds[s]),
                    self.shard_seg(seg, s)))
            return out
        device = msg.values.device
        vals = msg.values.cpu().numpy()
        idx = msg.indices.cpu().numpy()
        owner = self.owner_of(idx)
        seg_id = np.repeat(np.arange(len(seg)), tuple(seg))
        out = []
        for s in range(self.n_shards):
            m = owner == s
            sub_seg = tuple(int(c) for c in
                            np.bincount(seg_id[m], minlength=len(seg)))
            out.append((SparseLeaf(
                values=torch.from_numpy(vals[m]).to(device),
                indices=torch.from_numpy(
                    (idx[m] - self.bounds[s]).astype(np.int32)).to(device),
                size=self.bounds[s + 1] - self.bounds[s]), sub_seg))
        return out

    def merge(self, pieces):
        """Inverse of :meth:`split_by_shard`: per-shard pieces (shard
        order) -> one global arena message, indices rebased back by
        ``bounds[s]`` (bit-equal to the original for leaf-aligned
        splits)."""
        if not any(isinstance(p, SparseLeaf) for p in pieces):
            return torch.cat([p.to(torch.float32) for p in pieces])
        return SparseLeaf(
            values=torch.cat([p.values for p in pieces]),
            indices=torch.cat([p.indices + a
                               for p, a in zip(pieces, self.bounds)]),
            size=self.total)
