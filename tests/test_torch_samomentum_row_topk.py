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
import zlib

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
# multiple of 4, rows a stride ld > n apart, another lr
CASES = [(9, 4096, 205, "float"), (9, 512, 26, "float"),
         (7, 37, 37, "float"), (7, 1001, 50, "float"),
         (8, 300, 15, "strided"), (8, 300, 15, "another lr"),
         (6, block_topk.ROW_MAX, 410, "another lr")]
LR_ROWS = "(S, 1)"      # stands for a learning rate a row


@pytest.mark.parametrize("S,n,k,how", CASES)
def test_fused_plain_is_bit_equal_to_the_chain(S, n, k, how):
    u, g = rows(S, n, how)
    if how == "strided":      # leaf views of a (S, total) arena
        wide_u = torch.zeros(S, n + 9)
        wide_g = torch.zeros(S, n + 9)
        wide_u[:, 4:4 + n], wide_g[:, 4:4 + n] = u, g
        u, g = wide_u[:, 4:4 + n], wide_g[:, 4:4 + n]
    lr = 0.0371 if how == "another lr" else LR
    want = chain(u, g, lr, k)
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


@pytest.mark.parametrize("shape,ax", [((96, 40), 0),    # an embedding
                                      ((40, 96), 1),    # a column hint
                                      ((2, 24, 40), 2)])  # stacked layers
def test_allgather_exchange_fused_route_equals_the_chain(monkeypatch, shape,
                                                         ax):
    """Two steps of the blockwise allgather exchange on 4 lanes, through
    the fused pass and through the chain (the fused route refused): the
    same updates and velocities, bit for bit."""
    W = 4
    rng = _rng(shape, ax)
    grads = [torch.from_numpy(rng.normal(size=(W,) + shape)
                              .astype(np.float32)) for _ in range(2)]
    cfg = tdist.ExchangeConfig(mode="allgather", density=0.05, momentum=M,
                               engine="blockwise")
    assert not tdist.leaf_cut(shape, ax, cfg, W).flat

    def run():
        state = tdist.init_state({"p": torch.zeros(shape)}, cfg, W, lanes=W,
                                 shard_axes=[ax])
        upds = []
        for g in grads:
            upd, state = tdist.exchange(state, {"p": g}, cfg=cfg, lr=LR,
                                        mesh=LaneMesh(W, "cpu"),
                                        shard_axes=[ax])
            upds.append(upd["p"])
        return upds + [state.velocity["p"]]

    seen = _count_routes(monkeypatch)
    fused = run()
    assert seen == {"fused": 2 * W, "chain": 0}
    monkeypatch.setattr(engine, "_row_fused", lambda *a: False)
    _same(fused, run())


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


@pytest.mark.card
def test_samomentum_row_topk_bit_equal_on_the_card(card):
    """The kernel against its plain version (on the CPU): the cells' widths
    at fewer rows and the edges, at a 4-byte offset, strided, at two lr,
    and in place."""
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
