"""The row-wise SAMomentum step in one pass
(``block_topk.samomentum_row_topk_rows``) and the exchange's route to it.

On the CPU the wrapper runs its plain version; these tests hold it, bit for
bit, to the chain it replaces (``velocity_accumulate``, ``row_topk_plain``,
the support mask's rescale), check when ``engine.samomentum_step_rows``
takes it, and hold the allgather exchange through it to the exchange
through the chain.  The ``card`` test holds the CUDA kernel to the plain
version on the card:

    PYTHONPATH=src python -m pytest tests/test_torch_samomentum_row_topk.py -m card
"""
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as tdist
from repro_torch.core import engine
from repro_torch.kernels import block_topk, build
from repro_torch.launch.mesh import LaneMesh

M, LR = 0.9, 0.05


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def rows(S, n, seed):
    """(u, g), ``(S, n)`` float32, normal rows with adversarial rows in
    front: all zero, zeros of both signs in u and g, ties at the k-th
    magnitude of uacc (g zero, u a few values), ties from g alone (u zero),
    denormals, and one row of a single value."""
    rng = _rng(S, n, seed)
    u = rng.normal(size=(S, n)).astype(np.float32)
    g = rng.normal(size=(S, n)).astype(np.float32)
    sign = np.where(rng.random((2, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    planted = [
        (np.zeros(n), np.zeros(n)),
        (np.float32(0.0) * sign[0], np.float32(0.0) * sign[1]),
        (rng.integers(1, 4, n) * sign[0], np.zeros(n)),
        (np.zeros(n), rng.integers(1, 3, n) * sign[1]),
        (rng.integers(1, 9, n) * np.float32(1e-41) * sign[0],
         rng.integers(1, 9, n) * np.float32(1e-41) * sign[1]),
        (np.full(n, 0.75), np.full(n, -0.25)),
    ]
    for i, (uu, gg) in enumerate(planted[:S]):
        u[i], g[i] = uu, gg
    return torch.from_numpy(u), torch.from_numpy(g)


def chain(u2d, g2d, lr, k):
    """The five passes the fused step replaces, as the exchange ran them."""
    uacc = engine.velocity_accumulate(u2d, g2d, momentum=M, lr=lr)
    vals, idx = block_topk.row_topk_plain(uacc, k)
    mask = engine.rows_support_mask(idx, uacc.shape[1])
    return vals, idx, engine.samomentum_rescale(uacc, mask, M)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(_bits(g.contiguous()), _bits(w.contiguous()))


# (S, n, k, how): the cells' row widths at few rows, k = n, n odd and not a
# multiple of 4, rows a stride ld > n apart, another lr; and a leaf's rows
# where they live ("runs of <inner>", "columns": LEAF_CASES)
CASES = [(9, 4096, 205, "float"), (9, 512, 26, "float"),
         (7, 37, 37, "float"), (7, 1001, 50, "float"),
         (8, 300, 15, "strided"), (8, 300, 15, "another lr"),
         (6, block_topk.ROW_MAX, 410, "another lr")]
# segmented (wo, down), column (lm_head, wq, gate) at few rows, ragged S (13:
# no multiple of a column tile), the 2-wide bias rows, k = 1 and k = n (at
# ROW_MAX a column tile's CTA holds one row's keys at a time)
LEAF_CASES = [(9, 4096, 205, "runs of 2048"), (6, 8192, 410, "runs of 4096"),
              (10, 512, 1, "runs of 4"), (7, 12, 12, "runs of 4"),
              (13, 300, 15, "runs of 4"),
              (9, 4096, 205, "columns"), (13, 300, 15, "columns"),
              (11, 2, 1, "columns"), (8, 2, 2, "columns"),
              (7, 37, 37, "columns"),
              (5, block_topk.ROW_MAX, block_topk.ROW_MAX, "columns")]
LR_ROWS = "(S, 1)"      # stands for a learning rate a row


def as_leaf(x2d, how):
    """The ``(S, n)`` rows as a leaf's ``(outer, S, inner)`` view whose
    ``[:, s, :]`` is row s, laid out contiguous (``how``: "runs of
    <inner>" or "columns")."""
    S, n = x2d.shape
    inner = 1 if how == "columns" else int(how.split()[-1])
    return x2d.view(S, n // inner, inner).transpose(0, 1).contiguous()


def of_leaf(x3):
    """A leaf's ``(outer, S, inner)`` view back as its ``(S, n)`` rows."""
    return x3.transpose(0, 1).reshape(x3.shape[1], -1)


@pytest.mark.parametrize("S,n,k,how", CASES + LEAF_CASES)
def test_fused_plain_is_bit_equal_to_the_chain(S, n, k, how):
    u, g = rows(S, n, how)
    lr = 0.0371 if how == "another lr" else LR
    want = chain(u, g, lr, k)
    if how in {h for *_, h in LEAF_CASES}:
        u3, g3 = as_leaf(u, how), as_leaf(g, how)
        at = u3.data_ptr()
        vals, idx = block_topk.samomentum_row_topk_leaf(u3, g3, momentum=M,
                                                        lr=lr, k=k)
        assert u3.data_ptr() == at
        _same((vals, idx, of_leaf(u3)), want)
        return
    if how == "strided":      # leaf views of a (S, total) arena
        wide_u = torch.zeros(S, n + 9)
        wide_g = torch.zeros(S, n + 9)
        wide_u[:, 4:4 + n], wide_g[:, 4:4 + n] = u, g
        u, g = wide_u[:, 4:4 + n], wide_g[:, 4:4 + n]
    _same(block_topk.samomentum_row_topk_rows(u, g, momentum=M, lr=lr, k=k),
          want)
    # in place over u: the velocity is the chain's, u2d is the result
    vals, idx, got = block_topk.samomentum_row_topk_rows(
        u, g, momentum=M, lr=lr, k=k, out=u)
    assert got is u
    _same((vals, idx, u), want)


def _count_routes(monkeypatch):
    seen = {"fused": 0, "chain": 0}
    fused, sel = block_topk.samomentum_row_topk_plain, \
        engine._samomentum_select_rescale

    def fused_plain(*a, **kw):
        seen["fused"] += 1
        return fused(*a, **kw)

    def select_rescale(*a, **kw):
        seen["chain"] += 1
        return sel(*a, **kw)

    monkeypatch.setattr(block_topk, "samomentum_row_topk_plain", fused_plain)
    monkeypatch.setattr(engine, "_samomentum_select_rescale", select_rescale)
    return seen


BLOCKWISE = engine.CompressionSpec(engine="blockwise")


@pytest.mark.parametrize("n,k,spec,lr,route", [
    (block_topk.ROW_MAX, 410, BLOCKWISE, LR, "fused"),   # the row regime
    (2, 1, BLOCKWISE, LR, "fused"),                      # a bias
    (block_topk.ROW_MAX + 1, 410, BLOCKWISE, LR, "chain"),  # too long a row
    (4096, 205, engine.CompressionSpec(engine="blockwise", block_r=4), LR,
     "chain"),                                           # r < k: inexact
    (4096, 205, engine.CompressionSpec(engine="exact"), LR, "chain"),
    (4096, 205, engine.CompressionSpec(engine="blockwise", quantize="int8"),
     LR, "fused"),                                       # quantized after
    (4096, 205, BLOCKWISE, LR_ROWS, "chain"),            # lr one a row
])
def test_step_rows_takes_the_fused_pass_only_in_the_row_regime(
        monkeypatch, n, k, spec, lr, route):
    u, g = rows(3, n, "route")
    if lr == LR_ROWS:
        lr = torch.tensor([[0.05], [0.0371], [0.08]])
    want_vals, want_idx, want_u = chain(u, g, lr, k)
    seen = _count_routes(monkeypatch)
    out = torch.empty_like(u)
    vals, idx, u_new = engine.samomentum_step_rows(
        u, g, momentum=M, lr=lr, k=k, spec=spec, out=out)
    assert seen == {"fused": int(route == "fused"),
                    "chain": int(route == "chain")}
    assert u_new is out
    if spec.engine == "blockwise" and spec.block_r is None:
        _same((idx, u_new), (want_idx, want_u))
        _same((vals,), (engine._maybe_quantize_rows(want_vals,
                                                     spec.quantize),))


@pytest.mark.parametrize("shape,ax,access", [
    ((96, 40), 0, "rows"),           # an embedding
    ((40, 96), 1, "columns"),        # a column hint
    ((2, 24, 40), 2, "columns"),     # stacked layers, hinted last
    ((2, 24, 40), 1, "runs"),        # stacked layers, hinted in the middle
    ((2, 24), 1, "columns"),         # a 2-wide bias row
    ((2, 24, 6), 1, None)])          # runs of 6: copied into the rows
def test_allgather_exchange_fused_route_equals_the_chain(monkeypatch, shape,
                                                         ax, access):
    """Two steps of the blockwise allgather exchange on 4 lanes, through
    the fused pass and through the chain (the fused route refused): the
    same updates and velocities, bit for bit.  A leaf of an access is
    stepped where it lives, its velocity's own storage updated with no
    copy into the row layout; any other is copied there and back."""
    W = 4
    rng = _rng(shape, ax)
    grads = [torch.from_numpy(rng.normal(size=(W,) + shape)
                              .astype(np.float32)) for _ in range(2)]
    cfg = tdist.ExchangeConfig(mode="allgather", density=0.05, momentum=M,
                               engine="blockwise")
    cut = tdist.leaf_cut(shape, ax, cfg, W)
    assert not cut.flat
    view = tdist._leaf_rows(torch.zeros(shape), cut)
    assert block_topk.leaf_access(view, view) == access

    def run():
        state = tdist.init_state({"p": torch.zeros(shape)}, cfg, W, lanes=W,
                                 shard_axes=[ax])
        velocity, at = state.velocity["p"], state.velocity["p"].data_ptr()
        copies = tdist.ROWS_IN_COPIES
        upds = []
        for g in grads:
            upd, state = tdist.exchange(state, {"p": g}, cfg=cfg, lr=LR,
                                        mesh=LaneMesh(W, "cpu"),
                                        shard_axes=[ax])
            upds.append(upd["p"])
        assert state.velocity["p"] is velocity
        assert velocity.data_ptr() == at
        return upds + [velocity], tdist.ROWS_IN_COPIES - copies

    seen = _count_routes(monkeypatch)
    fused, copied = run()
    assert seen == {"fused": 2 * W, "chain": 0}
    assert copied == (0 if access else 2 * W)
    monkeypatch.setattr(engine, "_row_fused", lambda *a: False)
    chained, copied = run()
    assert copied == 2 * W
    _same(fused, chained)


@pytest.mark.parametrize("shape,k,lr", [
    ((2, block_topk.ROW_MAX + 1), 5, LR), ((2, 100), 0, LR),
    ((2, 100), 101, LR), ((100,), 5, LR), ((2, 100), 5, LR_ROWS)])
def test_samomentum_row_topk_rows_refuses_bad_shapes(shape, k, lr):
    if lr == LR_ROWS:
        lr = torch.full((shape[0], 1), LR)
    with pytest.raises(ValueError):
        block_topk.samomentum_row_topk_rows(torch.zeros(shape),
                                            torch.zeros(shape), momentum=M,
                                            lr=lr, k=k)


@pytest.mark.parametrize("view,dtype,contiguous,access", [
    ((1, 5, 8), torch.float32, True, "rows"),
    ((3, 5, 8), torch.float32, True, "runs"),
    ((15, 5, 1), torch.float32, True, "columns"),
    ((3, 5, 6), torch.float32, True, None),          # runs not of 4
    ((3, 5, 8), torch.bfloat16, True, None),         # g not float32
    ((3, 5, 8), torch.float32, False, None),         # g not contiguous
    ((2, 5, block_topk.ROW_MAX), torch.float32, True, None),  # too wide
    ((1, 5, block_topk.ROW_MAX), torch.float32, True, "rows")])
def test_leaf_access_follows_the_view(view, dtype, contiguous, access):
    """The access is read off the leaf's ``(outer, S, inner)`` view, its
    stride and dtype alone; a view of no access is refused by the step."""
    outer, S, inner = view
    u3 = torch.zeros(view)
    g3 = torch.zeros(view, dtype=dtype) if contiguous else \
        torch.zeros((outer, inner, S), dtype=dtype).transpose(1, 2)
    assert block_topk.leaf_access(u3, g3) == access
    if access is None:
        with pytest.raises(ValueError, match="no access"):
            block_topk.samomentum_row_topk_leaf(u3, g3, momentum=M, lr=LR,
                                                k=1)


def test_wrapper_never_builds_for_the_cpu_and_raises_elsewhere(monkeypatch):
    def no_build(*a, **kw):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(build, "library", no_build)
    before = block_topk.SAM_ROW_INFO.launches
    u, g = rows(3, 300, "cpu")
    block_topk.samomentum_row_topk_rows(u, g, momentum=M, lr=LR, k=10)
    assert block_topk.SAM_ROW_INFO.launches == before
    meta = torch.empty(2, 300, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        block_topk.samomentum_row_topk_rows(meta, meta, momentum=M, lr=LR,
                                            k=10)


def _cell_leaves():
    """``chip_smoke.cell_leaves``: every hinted leaf that the benchmark's
    allgather cells step where they live, (shape, hinted dim, cut), from
    ``shard_axis_hints`` on their configurations."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke.cell_leaves(torch)


def test_the_cells_leaves_take_every_access():
    """The card's leaves come from the cells' configurations: all three
    accesses, and the widths of each allgather cell (DeepSeek's 2,048-wide
    lm_head and dense columns, its MLA's wkv_b) among them."""
    leaves = {(shape, ax): cut for shape, ax, cut in _cell_leaves()}
    accesses = {block_topk.leaf_access(*[tdist._leaf_rows(
        torch.empty(shape, device="meta"), cut)] * 2)
        for (shape, _), cut in leaves.items()}
    assert accesses == {"rows", "runs", "columns"}
    for shape, ax, rows in [((4096, 65024), 1, (65024, 4096)),
                            ((2048, 12800), 1, (12800, 2048)),
                            ((2048, 10944), 1, (10944, 2048)),
                            ((8, 512, 4096), 2, (4096, 4096)),
                            ((2, 768, 3840), 2, (3840, 1536))]:
        assert (leaves[(shape, ax)].S, leaves[(shape, ax)].rest) == rows


GUARD = 16      # floats of guard band on each side of a leaf on the card


def _leaf_on_the_card(card, shape, ax, cut, how, seed):
    """A leaf's u and g on the card in guard bands of NaN, at an aligned
    base or one 4 bytes past it, and its rows ``(S, n)`` of the cut with
    the adversarial rows planted first.  Returns (u3, g3, u_rows, g_rows,
    buf, the leaf's offset in buf)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    rows_u = torch.randn(cut.S, cut.rest, generator=gen, device=card)
    rows_g = torch.randn(cut.S, cut.rest, generator=gen, device=card)
    pu, pg = rows(6, cut.rest, "card leaf")
    h = min(6, cut.S)
    rows_u[:h], rows_g[:h] = pu[:h].to(card), pg[:h].to(card)
    size = cut.S * cut.rest
    off = GUARD + (how == "4-byte offset")
    buf = torch.full((2, size + 2 * GUARD + 4), float("nan"), device=card)
    leaf = buf[:, off:off + size].view((2,) + shape)
    for i, x in enumerate((rows_u, rows_g)):
        leaf[i].movedim(ax, 0).copy_(x.view(
            (shape[ax],) + shape[:ax] + shape[ax + 1:]))
    u3, g3 = (tdist._leaf_rows(leaf[i], cut) for i in range(2))
    return u3, g3, rows_u, rows_g, buf, off


@pytest.mark.card
def test_samomentum_row_topk_bit_equal_on_the_card(card):
    """The kernel against its plain version (on the CPU): the cells' widths
    at fewer rows and the edges, at a 4-byte offset, strided, at two lr,
    and in place.  Then the leaf's accesses (rows, runs, columns) in place
    at every hinted leaf that the allgather cells' configurations step
    where it lives (``_cell_leaves``) and the edges' (ragged S, k = 1 and
    k = n, the bias rows), aligned and 4 bytes off (the narrow path),
    against the plain version on the card: the guard bands around the
    leaf untouched, one launch counted on the access's kernel."""
    for S, n, k, how in LEAF_CASES:
        u, g = rows(S, n, how)
        want = chain(u, g, LR, k)
        u3, g3 = as_leaf(u, how).to(card), as_leaf(g, how).to(card)
        vals, idx = block_topk.samomentum_row_topk_leaf(u3, g3, momentum=M,
                                                        lr=LR, k=k)
        _same([vals.cpu(), idx.cpu(), of_leaf(u3).cpu()], want)
    for shape, ax, cut in _cell_leaves():
        for how in ("aligned", "4-byte offset"):
            u3, g3, ru, rg, buf, off = _leaf_on_the_card(card, shape, ax, cut,
                                                         how, 35)
            want = block_topk.samomentum_row_topk_plain(ru, rg, momentum=M,
                                                        lr=LR, k=cut.k_row)
            info = {"rows": block_topk.SAM_ROW_INFO,
                    "runs": block_topk.SAM_SEG_INFO,
                    "columns": block_topk.SAM_COL_INFO}[
                        block_topk.leaf_access(u3, g3)]
            before = info.launches
            got = block_topk.samomentum_row_topk_leaf(u3, g3, momentum=M,
                                                      lr=LR, k=cut.k_row)
            assert info.launches == before + 1
            _same([t.cpu() for t in (*got, of_leaf(u3))],
                  [t.cpu() for t in want])
            size = ru.numel()
            for row in buf:
                assert bool(row[:off].isnan().all())
                assert bool(row[off + size:].isnan().all())
            del u3, g3, ru, rg, buf, want, got
            torch.cuda.empty_cache()
    for S, n, k, _ in CASES + [(512, 8192, 410, ""), (1024, 4096, 205, ""),
                               (12, 2, 1, ""), (12, 4096, 4096, "")]:
        u, g = rows(S, n, "card")
        for lr_c in (LR, 0.0371):
            want = chain(u, g, lr_c, k)
            uc, gc = u.to(card), g.to(card)
            shifted = torch.zeros(2, S * n + 1, device=card)
            shifted[0, 1:], shifted[1, 1:] = uc.reshape(-1), gc.reshape(-1)
            wide = torch.zeros(2, S, n + 7, device=card)
            wide[0, :, 3:3 + n], wide[1, :, 3:3 + n] = uc, gc
            for uv, gv in ((uc, gc),
                           (shifted[0, 1:].view(S, n),
                            shifted[1, 1:].view(S, n)),
                           (wide[0, :, 3:3 + n], wide[1, :, 3:3 + n])):
                got = block_topk.samomentum_row_topk_rows(
                    uv, gv, momentum=M, lr=lr_c, k=k)
                _same([t.cpu() for t in got], want)
                block_topk.samomentum_row_topk_rows(
                    uv, gv, momentum=M, lr=lr_c, k=k, out=uv)
                _same([uv.cpu()], want[2:])
