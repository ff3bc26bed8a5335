"""The row regime of kernel row 3 (``block_topk.row_topk_rows``) and the
blockwise engine's dispatch to it.

On the CPU the wrapper runs its plain version; these tests hold the engine's
row path to the exact engine and to the hierarchy it replaces
(``ops.hierarchical_topk_rows`` at r = k), bit for bit, at the benchmark
cells' row shapes with fewer rows, and check which path the engine takes.
The ``card`` test holds the CUDA kernel to the plain version on the card:

    PYTHONPATH=src python -m pytest tests/test_torch_row_topk.py -m card
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.core.engine import BlockwiseEngine, ExactEngine
from repro_torch.kernels import block_topk, build, ops

# (S, n, k): the cells' row shapes -- chatglm3-6b's embedding and MLP rows,
# minicpm3-4b's shortest and longest hinted rows, a shardedps downward row
CELL_ROWS = [(65024, 4096, 205), (13696, 8192, 410), (5120, 512, 26),
             (6400, 5120, 256), (2, 1024, 51)]


def planted(S, n, seed):
    """Normal rows with adversarial rows in front: all zero, zeros of both
    signs, two values of opposite sign, denormals of both signs, NaN among
    normals, infinities, small integers, and ties around a 5% boundary."""
    rng = np.random.default_rng(zlib.crc32(repr((S, n, seed)).encode()))
    x = rng.normal(size=(S, n)).astype(np.float32)
    base = rng.normal(size=(4, n)).astype(np.float32)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    tiny = np.float32(1e-41)
    rows = [np.zeros(n, np.float32), np.float32(0.0) * sign,
            np.float32(0.25) * sign,
            rng.integers(1, 9, n).astype(np.float32) * tiny * sign]
    b = base[0].copy()
    b[::17] = np.nan
    rows.append(b)
    b = base[1].copy()
    b[::13], b[1::13] = np.inf, -np.inf
    rows.append(b)
    rows.append(np.round(base[2] * 2))
    b = base[3].copy()
    b[np.abs(b) > 1.6] = 2.0 * np.sign(b[np.abs(b) > 1.6])
    rows.append(b)
    for i, row in enumerate(rows[:S]):
        x[i] = row
    return x


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("S,n,k", [(min(S, 9), n, k)
                                   for S, n, k in CELL_ROWS])
def test_blockwise_equals_exact_at_the_cells_row_shapes(S, n, k):
    x = torch.from_numpy(planted(S, n, "cells"))
    got = BlockwiseEngine().select_rows(x, k)
    _same(got, ExactEngine().select_rows(x, k))
    _same(got, ops.hierarchical_topk_rows(x, k=k, r=k))


@pytest.mark.parametrize("n,k", [(4096, 1), (4096, 64), (4096, 65),
                                 (4096, 1500), (1000, 1000), (1000, 33),
                                 (37, 5), (block_topk.ROW_MAX, 410)])
def test_row_topk_plain_equals_the_hierarchy_at_the_edges(n, k):
    """k = 1, around the block regime's switch, above a block, k = n, n
    not a multiple of 32 or of 4, n = ROW_MAX; every planted row."""
    x = torch.from_numpy(planted(9, n, "edges"))
    got = block_topk.row_topk_rows(x, k)
    _same(got, block_topk.row_topk_plain(x, k))
    _same(got, ops.hierarchical_topk_rows(x, k=k, r=k))


def _count_paths(monkeypatch):
    """Counts of the row regime's and the block top-k's plain versions."""
    seen = {"row": 0, "block": 0}
    row, blk = block_topk.row_topk_plain, block_topk.block_topk_plain

    def row_plain(x2d, k):
        seen["row"] += 1
        return row(x2d, k)

    def block_plain(x2d, r):
        seen["block"] += 1
        return blk(x2d, r)

    monkeypatch.setattr(block_topk, "row_topk_plain", row_plain)
    monkeypatch.setattr(block_topk, "block_topk_plain", block_plain)
    return seen


@pytest.mark.parametrize("n,k,block_r,path", [
    (block_topk.ROW_MAX, 410, None, "row"),       # exact plan, fits a CTA
    (block_topk.ROW_MAX + 1, 410, None, "block"),  # too long a row
    (4096, 205, 4, "block"),                       # r < k: not exact
    (4096, 205, 300, "row"),                       # r >= k
    (4096, 1500, None, "row"),                     # r = BLOCK < k
    (2048, 2, 32, "row"),                          # a bias at block_r 32
])
def test_dispatch_takes_the_row_regime_only_for_short_rows_and_exact_plans(
        monkeypatch, n, k, block_r, path):
    seen = _count_paths(monkeypatch)
    x = torch.from_numpy(planted(3, n, "dispatch"))
    eng = BlockwiseEngine(block_r=block_r)
    got = eng.select_rows(x, k)
    assert seen == {"row": int(path == "row"), "block": int(path == "block")}
    if path == "row":
        _same(got, ExactEngine().select_rows(x, k))


@pytest.mark.parametrize("shape,k", [((2, block_topk.ROW_MAX + 1), 5),
                                     ((2, 100), 0), ((2, 100), 101),
                                     ((100,), 5), ((2, 0), 1)])
def test_row_topk_rows_refuses_bad_shapes(shape, k):
    with pytest.raises(ValueError):
        block_topk.row_topk_rows(torch.zeros(shape), k)


def test_row_topk_wrapper_never_builds_for_the_cpu_and_raises_elsewhere(
        monkeypatch):
    def no_build(*a, **kw):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(build, "library", no_build)
    before = block_topk.ROW_INFO.launches
    block_topk.row_topk_rows(torch.randn(3, 300), 10)
    assert block_topk.ROW_INFO.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        block_topk.row_topk_rows(torch.empty(2, 300, device="meta"), 10)


@pytest.mark.card
def test_row_topk_bit_equal_on_the_card(card):
    """The kernel against its plain version (on the CPU) and against the
    hierarchy (on the card): the cells' widths at fewer rows, the edges,
    a 4-byte offset and strided rows."""
    cases = [(min(S, 2048), n, (k,)) for S, n, k in CELL_ROWS]
    cases += [(12, 4096, (1, 64, 65, 1500, 4096)), (12, 1000, (1, 33, 1000)),
              (12, 37, (1, 5, 37)),
              (12, block_topk.ROW_MAX, (1, 410, block_topk.ROW_MAX))]
    for S, n, ks in cases:
        x = torch.from_numpy(planted(S, n, "card"))
        xc = x.to(card)
        shifted = torch.zeros(S * n + 1, device=card)
        shifted[1:] = xc.reshape(-1)
        wide = torch.zeros(S, n + 7, device=card)
        wide[:, 3:3 + n] = xc
        for k in ks:
            want = block_topk.row_topk_plain(x, k)
            for view in (xc, shifted[1:].view(S, n), wide[:, 3:3 + n]):
                got = block_topk.row_topk_rows(view, k)
                _same([t.cpu() for t in got], want)
            _same(got, ops.hierarchical_topk_rows(xc, k=k, r=k))
