"""The port's core modules on the CPU, against the JAX reference.

Inputs are made with numpy and fed to both packages.  Where the reference
jits a computation (the strategy and server stages, the quantizer), the
reference side here is jitted too: XLA's fused roundings are the reference's
numbers (see repro_torch/arith.py).
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import wire as jwire
from repro.core import async_sim as jsim
from repro.core import baselines as jbase
from repro.core import engine as jengine
from repro.core import server as jserver
from repro.core import sparsify as jsp
from repro.core.paramspace import ParamSpace as JSpace
from repro_torch.cluster import wire as twire
from repro_torch.convert import params_from_numpy
from repro_torch.core import async_sim as tsim
from repro_torch.core import baselines as tbase
from repro_torch.core import engine as tengine
from repro_torch.core import server as tserver
from repro_torch.core import sparsify as tsp
from repro_torch.core.paramspace import ParamSpace as TSpace
from repro_torch.core.sparsify import SparseLeaf


def _rng(*words):
    return np.random.default_rng(zlib.crc32(repr(words).encode()))


def _eq(t, j):
    t = t.float().numpy() if t.is_floating_point() else t.numpy()
    j = np.asarray(j, np.float32) if jnp.issubdtype(j.dtype, jnp.floating) \
        else np.asarray(j)
    np.testing.assert_array_equal(t, j)


def _eq_leaf(t, j):
    _eq(t.values, j.values)
    _eq(t.indices, j.indices)
    assert t.size == j.size


def _params(rng):
    return {"w1": rng.normal(size=(64, 64)).astype(np.float32),
            "b1": rng.normal(size=64).astype(np.float32),
            "w2": rng.normal(size=(64, 10)).astype(np.float32),
            "b2": rng.normal(size=10).astype(np.float32)}


def _planted(rng, n):
    x = rng.normal(size=n).astype(np.float32)
    x[::5] = 0.75            # magnitude ties, both signs
    x[2::9] = -0.75
    return x


# ------------------------------------------------------------ ParamSpace

def test_leaf_order_sorts_keys_like_jax():
    p = _params(_rng("order"))
    ts, js = TSpace.from_tree(params_from_numpy(p, "cpu")), JSpace.from_tree(p)
    assert [path[-1] for path in ts.paths] == ["b1", "b2", "w1", "w2"]
    assert (ts.offsets, ts.sizes, ts.shapes, ts.total) == \
        (js.offsets, js.sizes, js.shapes, js.total)


@pytest.mark.parametrize("tree", [
    {"z": np.ones(3), "a": {"y": np.arange(4.0), "b": np.full((2, 2), 2.0)}},
    {"w10": np.ones(2), "w2": np.zeros(5), "B": np.arange(3.0)},
])
def test_nested_and_lexicographic_order(tree):
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    ts, js = TSpace.from_tree(params_from_numpy(tree, "cpu")), JSpace.from_tree(tree)
    _eq(ts.pack(params_from_numpy(tree, "cpu")), js.pack(tree))
    assert ts.offsets == js.offsets


def test_pack_unpack_round_trip_and_views():
    p = _params(_rng("pack"))
    tp = params_from_numpy(p, "cpu")
    ts, js = TSpace.from_tree(tp), JSpace.from_tree(p)
    flat = ts.pack(tp)
    _eq(flat, js.pack(p))
    back = ts.unpack(flat)
    for key in p:
        assert back[key].shape == tp[key].shape
        assert torch.equal(back[key], tp[key])
    back["w1"][0, 0] = 123.0            # unpack hands out views
    assert flat[ts.offsets[2]] == 123.0
    assert ts.ks(0.01) == js.ks(0.01)


def test_select_and_split_match_reference():
    p = _params(_rng("select"))
    x = _planted(_rng("x"), 64 * 64 + 64 + 640 + 10)
    ts, js = TSpace.from_tree(params_from_numpy(p, "cpu")), JSpace.from_tree(p)
    ks = ts.ks(0.05)
    t = ts.select(torch.from_numpy(x), ks, tengine.EXACT_SPEC)
    j = js.select(jnp.asarray(x), ks, jengine.EXACT_SPEC)
    _eq_leaf(t, j)
    for a, b in zip(ts.split(t, ks), js.split(j, ks)):
        _eq_leaf(a, b)


# ------------------------------------------------------------ sparsify

@pytest.mark.parametrize("n,k", [(50, 7), (1000, 37), (20000, 500)])
def test_topk_tie_breaking_matches_lax_top_k(n, k):
    x = _planted(_rng("ties", n), n)
    _eq_leaf(tsp.topk_select(torch.from_numpy(x), k),
             jsp.topk_select(jnp.asarray(x), k))
    _eq(tsp.topk_mask(torch.from_numpy(x), k),
        jsp.topk_mask(jnp.asarray(x), k))
    _eq(tsp.topk_threshold(torch.from_numpy(x), k),
        jsp.topk_threshold(jnp.asarray(x), k))


@pytest.mark.parametrize("n,density,sample", [(10000, 0.01, 4096),
                                              (70000, 0.001, 65536),
                                              (999, 0.3, 100)])
def test_sampled_threshold_ceil_stride(n, density, sample):
    x = _rng("st", n).normal(size=n).astype(np.float32)
    _eq(tsp.sampled_threshold(torch.from_numpy(x), density,
                              sample_size=sample),
        jsp.sampled_threshold(jnp.asarray(x), density, sample_size=sample))


def test_density_to_k_sweep():
    for size in (1, 7, 100, 4719, 10_512_650):
        for d in (0.001, 0.01, 0.15, 1.0):
            assert tsp.density_to_k(size, d) == jsp.density_to_k(size, d)
    with pytest.raises(ValueError):
        tsp.density_to_k(10, 0.0)


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
@pytest.mark.parametrize("n", [1, 19, 1000])
def test_quantize_parts_bit_equal(mode, n):
    v = (_rng("q", mode, n).normal(size=n)
         * 10 ** _rng("s", n).uniform(-6, 3)).astype(np.float32)
    for a, b in zip(tsp.quantize_parts(torch.from_numpy(v), mode),
                    jsp.quantize_parts(jnp.asarray(v), mode)):
        _eq(a, b)


@pytest.mark.parametrize("n", [2, 19, 1000, 10514])
def test_quantize_tern(n):
    """tern's scale is a sum: the port adds in index order, as XLA does for
    short segments (bit-equal up to ~20 elements); longer ones XLA
    reorders, and a float32 sum of n terms in another order agrees to about
    n * 2**-24 relative in the worst case, 1e-5 for these n."""
    v = _rng("tern", n).normal(size=n).astype(np.float32)
    v[::4] = 0.0
    tc, ts_, tq = tsp.quantize_parts(torch.from_numpy(v), "tern")
    jc, js_, jq = jsp.quantize_parts(jnp.asarray(v), "tern")
    _eq(tc, jc)
    if n <= 19:
        _eq(ts_, js_)
        _eq(tq, jq)
    else:
        np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), rtol=1e-5)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5)


@pytest.mark.parametrize("mode", ["bf16", "int8", "tern"])
def test_quantize_segments_one_scale_per_tensor(mode):
    v = _rng("seg", mode).normal(size=30).astype(np.float32)
    seg = (3, 12, 15)
    _eq(tsp.quantize_segments(torch.from_numpy(v), mode, seg),
        jsp.quantize_segments(jnp.asarray(v), mode, seg))


# ------------------------------------------------------------ engines

_ENGINE_SPECS = [dict(engine="exact"), dict(engine="sampled"),
                 dict(engine="sampled", sample_size=500),
                 dict(engine="blockwise", block_r=4),
                 dict(engine="blockwise", block_r=None),
                 dict(engine="auto", sampled_threshold_above=3000)]


@pytest.mark.parametrize("spec", _ENGINE_SPECS)
@pytest.mark.parametrize("n,k", [(700, 35), (5000, 50), (9000, 120)])
def test_engine_select_bit_equal(spec, n, k):
    x = _planted(_rng("eng", n, str(spec)), n)
    t = tengine.select(torch.from_numpy(x), k,
                       tengine.CompressionSpec(quantize="int8", **spec))
    j = jengine.select(jnp.asarray(x), k,
                       jengine.CompressionSpec(quantize="int8", **spec))
    _eq_leaf(t, j)


@pytest.mark.parametrize("spec", _ENGINE_SPECS[:5])
def test_samomentum_step_bit_equal(spec):
    rng = _rng("sam", str(spec))
    u = rng.normal(size=(60, 50)).astype(np.float32)
    g = rng.normal(size=(60, 50)).astype(np.float32)
    u.reshape(-1)[::13] = 0.5
    kw = dict(momentum=0.7, lr=0.05, k=60)
    t_msg, t_u = tengine.samomentum_step(
        torch.from_numpy(u), torch.from_numpy(g),
        spec=tengine.CompressionSpec(**spec), **kw)
    j_msg, j_u = jax.jit(lambda u, g: jengine.samomentum_step(
        u, g, spec=jengine.CompressionSpec(**spec), **kw))(u, g)
    _eq_leaf(t_msg, j_msg)
    _eq(t_u, j_u)


@pytest.mark.parametrize("B", [1, 3])
def test_blockwise_step_rows_bit_equal_to_reference_per_row(B):
    """The port's row-wise blockwise step (accumulate on strided leaf views
    of a wider arena, selection, fused pass, repair, fma epilogue) at
    ``block_r=4``, one learning rate per row, against the reference's
    jitted ``_samomentum_step_blockwise`` on each row: values, indices and
    the new velocity bit for bit; and ``velocity_accumulate`` alone against
    the reference's step's first line."""
    rng = _rng("bwrows", B)
    n, k, off = 3000, 40, 5
    u = np.stack([_planted(rng, n) for _ in range(B)])
    g = rng.normal(size=(B, n)).astype(np.float32)
    lrs = np.asarray([0.05, 0.1, 0.013][:B], np.float32)
    spec = dict(engine="blockwise", block_r=4)
    jeng = jengine.get_engine("blockwise", jengine.CompressionSpec(**spec))
    teng = tengine.get_engine("blockwise", tengine.CompressionSpec(**spec))
    step = jax.jit(lambda u, g, lr: jengine._samomentum_step_blockwise(
        u, g, jeng, momentum=0.7, lr=lr, k=k))
    acc = jax.jit(lambda u, g, lr: jengine.velocity_accumulate(
        u, g, momentum=0.7, lr=lr))
    arena = torch.zeros(2, B, n + 11)
    arena[0, :, off:off + n] = torch.from_numpy(u)
    arena[1, :, off:off + n] = torch.from_numpy(g)
    tu, tg = arena[0, :, off:off + n], arena[1, :, off:off + n]
    tlr = torch.from_numpy(lrs)[:, None]
    vals, idx, u_new = tengine._samomentum_step_blockwise_rows(
        tu, tg, teng, momentum=0.7, lr=tlr, k=k)
    uacc = tengine.velocity_accumulate(tu, tg, momentum=0.7, lr=tlr)
    for b in range(B):
        msg, want_u = step(u[b], g[b], lrs[b])
        _eq(vals[b], msg.values)
        _eq(idx[b], msg.indices)
        np.testing.assert_array_equal(u_new[b].numpy().view(np.int32),
                                      np.asarray(want_u).view(np.int32))
        np.testing.assert_array_equal(
            uacc[b].numpy().view(np.int32),
            np.asarray(acc(u[b], g[b], lrs[b])).view(np.int32))


def test_engine_registry():
    assert set(tengine.ENGINES) == {"exact", "sampled", "blockwise"}
    assert isinstance(tengine.resolve_engine(tengine.DEFAULT_SPEC, 10),
                      tengine.ExactEngine)
    assert isinstance(tengine.resolve_engine(tengine.DEFAULT_SPEC, 1 << 20),
                      tengine.SampledEngine)
    with pytest.raises(ValueError, match="unknown engine"):
        tengine.get_engine("nope")
    for n, k, r in [(4719, 5, 4), (5000, 40, None), (100, 100, None)]:
        assert tengine.BlockwiseEngine(block_r=r)._plan(n, k) == \
            jengine.BlockwiseEngine(block_r=r)._plan(n, k)


# ------------------------------------------------------------ strategies

def _grad_fns():
    def j_grad(p, t):
        grads = jax.tree.map(lambda w, x: w - x, p, t)
        return sum(jnp.sum(g ** 2) for g in jax.tree.leaves(grads)), grads

    def t_grad(p, t):
        grads = {k: p[k] - t[k] for k in p}
        return sum(torch.sum(g ** 2) for g in grads.values()), grads

    return j_grad, t_grad


@pytest.mark.parametrize("name,kw", [
    ("asgd", {}),
    ("gd_async", dict(density=0.05)),
    ("dgc_async", dict(density=0.05)),
    ("dgs", dict(density=0.05)),
    ("dgs", dict(density=0.05, engine="sampled")),
    ("dgs", dict(density=0.01, engine="blockwise")),
    ("dgs_plain", dict(density=0.05)),
])
def test_strategy_step_bit_equal(name, kw):
    """Three client steps through the reference's own (jitted) client
    stage and the port's, from the same model and targets."""
    rng = _rng("strat", name, str(kw))
    p = _params(rng)
    targets = [_params(rng) for _ in range(3)]
    j_grad, t_grad = _grad_fns()
    js, ts = JSpace.from_tree(p), TSpace.from_tree(params_from_numpy(p, "cpu"))
    jstrat = jbase.make_strategy(name, **kw)
    tstrat = tbase.make_strategy(name, **kw)
    jstep = jsim.make_client_step(jstrat, j_grad, js)
    tstep = tsim.make_client_step(tstrat, t_grad, ts)
    jtheta, ttheta = js.pack(p), ts.pack(params_from_numpy(p, "cpu"))
    jst, tst = jstrat.init(p), tstrat.init(params_from_numpy(p, "cpu"))
    for e, t in enumerate(targets):
        jst, jl, jm = jstep(jtheta, jst, t, 0.05 * (e + 1))
        tst, tl, tm = tstep(ttheta, tst, params_from_numpy(t, "cpu"), 0.05 * (e + 1))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        if isinstance(tm, SparseLeaf):
            _eq_leaf(tm, jm)
        else:
            _eq(tm, jm)
        for a, b in zip(jax.tree.leaves(tuple(tst)), jax.tree.leaves(
                tuple(jst))):
            _eq(a, b)
        assert tstrat.message_seg(ts) == jstrat.message_seg(js)
        assert tstrat.value_bits == jstrat.value_bits


def test_msgd_step_matches_reference():
    rng = _rng("msgd")
    p, v, g = _params(rng), _params(rng), _params(rng)
    jp, jv = jax.jit(lambda p, v, g: jbase.msgd_step(
        p, v, g, lr=0.1, momentum=0.7))(p, v, g)
    tp, tv = tbase.msgd_step(params_from_numpy(p, "cpu"), params_from_numpy(v, "cpu"),
                             params_from_numpy(g, "cpu"), lr=0.1, momentum=0.7)
    for key in p:
        _eq(tv[key], jv[key])
        _eq(tp[key], jp[key])


def test_make_strategy_unknown():
    with pytest.raises(ValueError, match="unknown strategy"):
        tbase.make_strategy("sgd")


# ------------------------------------------------------------ server

def _server_pair(n_workers=3):
    rng = _rng("server")
    p = _params(rng)
    return p, tserver.init(params_from_numpy(p, "cpu"), n_workers), \
        jserver.init(p, n_workers)


def _eq_state(t, j):
    _eq(t.M, j.M)
    _eq(t.v, j.v)
    assert t.t == int(j.t)


@pytest.mark.parametrize("sec,spec", [
    (None, dict(engine="exact")),
    (0.05, dict(engine="exact", quantize="int8")),
    # tern at segments of <= 16 entries, where its sum is bit-equal
    (0.004, dict(engine="blockwise", block_r=4, quantize="tern")),
    (0.05, dict(engine="blockwise", block_r=4, quantize="int8")),
    (0.1, dict(engine="sampled", quantize="bf16")),
])
def test_server_stages_bit_equal(sec, spec):
    p, ts, js = _server_pair()
    rng = _rng("msgs", sec)
    space = TSpace.from_tree(params_from_numpy(p, "cpu"))
    ks = space.ks(0.05)
    tspec = tengine.CompressionSpec(**spec)
    jspec = jengine.CompressionSpec(**spec)
    for e, k in enumerate([0, 2, 1, 0, 2]):
        x = rng.normal(size=space.total).astype(np.float32)
        if e % 2:   # a dense (ASGD) message
            tm, jm = torch.from_numpy(x), jnp.asarray(x)
        else:
            tm = space.select(torch.from_numpy(x), ks, tengine.EXACT_SPEC)
            jm = jax.tree.map(jnp.asarray, SparseLeaf(
                values=tm.values.numpy(), indices=tm.indices.numpy(),
                size=tm.size))
            jm = jsp.SparseLeaf(jm.values, jm.indices, jm.size)
        ts = tserver.receive(ts, tm)
        js = jserver.receive(js, jm)
        ts, tG = tserver.send(ts, k, secondary_density=sec, spec=tspec)
        js, jG = jserver.send(js, k, secondary_density=sec, spec=jspec)
        _eq_state(ts, js)
        if sec is None:
            _eq(tG, jG)
            assert torch.equal(ts.v[k], ts.M)       # the dense snap
            assert tserver.message_nnz(tG) == jserver.message_nnz(jG)
        else:
            _eq_leaf(tG, jG)
            assert tserver.message_nnz(tG) == sum(space.ks(sec))
    tp = tserver.global_model(params_from_numpy(p, "cpu"), ts)
    jp = jserver.global_model(p, js)
    for key in p:
        _eq(tp[key], jp[key])


def test_send_commit_dense_snaps_to_a_copy_of_M():
    """A dense commit sets v_k to M exactly; it does not add M - v_k."""
    p, ts, _ = _server_pair()
    ts.M.copy_(torch.from_numpy(
        _rng("snap").normal(size=ts.M.shape[0]).astype(np.float32)) * 1e7)
    ts.v[1].copy_(ts.M / 3)
    ts = tserver.send_commit(ts, 1, ts.M - ts.v[1])
    assert torch.equal(ts.v[1], ts.M)
    assert ts.v[1].data_ptr() != ts.M.data_ptr()


def test_worker_slots_and_apply():
    p, ts, js = _server_pair(2)
    ts.v[1].fill_(3.0)
    js = js._replace(v=js.v.at[1].set(3.0))
    ts, tid = tserver.add_worker(ts)
    js, jid = jserver.add_worker(js)
    assert tid == jid == 2
    _eq(ts.v, js.v)
    ts = tserver.reset_worker(ts, 1)
    js = jserver.reset_worker(js, 1)
    _eq(ts.v, js.v)
    rng = _rng("apply")
    theta = rng.normal(size=ts.M.shape[0]).astype(np.float32)
    idx = rng.permutation(theta.size)[:40].astype(np.int32)
    vals = rng.normal(size=40).astype(np.float32)
    G = SparseLeaf(torch.from_numpy(vals), torch.from_numpy(idx), theta.size)
    jG = jsp.SparseLeaf(jnp.asarray(vals), jnp.asarray(idx), theta.size)
    tt = torch.from_numpy(theta.copy())
    assert tserver.apply_update(tt, G) is tt
    _eq(tt, jserver.apply_update(jnp.asarray(theta), jG))
    tpp = tserver.apply_to_params(params_from_numpy(p, "cpu"), G)
    jpp = jserver.apply_to_params(p, jG)
    for key in p:
        _eq(tpp[key], jpp[key])


# ------------------------------------------------------------ wire

@pytest.mark.parametrize("mode", ["none", "bf16", "int8", "tern"])
@pytest.mark.parametrize("size", [10, 256, 257, 65536, 65537, 10_512_650])
def test_wire_byte_formulas(mode, size):
    for seg in [(1,), (3, 5, 7), tuple(range(1, 9)), (2, 2, 4719, 4719, 20)]:
        assert twire.frame_bytes_static(seg, size, mode) == \
            jwire.frame_bytes_static(seg, size, mode)
        assert twire.arena_frame_bytes(seg, size, mode) == \
            jwire.arena_frame_bytes(seg, size, mode)
        for kind in (twire.SPARSE, twire.DENSE, twire.DENSE_COO):
            assert twire.leaf_frame_bytes(sum(seg), size, mode, kind) == \
                jwire.leaf_frame_bytes(sum(seg), size, mode, kind)
    nnz = np.asarray([0, 1, size // 3, size])
    np.testing.assert_array_equal(twire.dense_frame_bytes(nnz, size),
                                  jwire.dense_frame_bytes(nnz, size))
    assert twire.index_dtype(size) == jwire.index_dtype(size)
    assert twire.ENVELOPE_BYTES == jwire.ENVELOPE_BYTES
    assert twire._value_nbytes(size, mode) == jwire._value_nbytes(size, mode)


@pytest.mark.parametrize("mode", ["none", "int8", "tern"])
def test_quantize_message(mode):
    v = _rng("qm", mode).normal(size=12).astype(np.float32)
    idx = np.arange(12, dtype=np.int32)
    t = twire.quantize_message(
        SparseLeaf(torch.from_numpy(v), torch.from_numpy(idx), 50), mode,
        seg=(5, 7))
    j = jwire.quantize_message(
        jsp.SparseLeaf(jnp.asarray(v), jnp.asarray(idx), 50), mode,
        seg=(5, 7))
    _eq_leaf(t, j)
    dense = torch.from_numpy(v)
    assert twire.quantize_message(dense, mode) is dense


def test_compression_spec_fields_mirror_reference():
    t = {f.name for f in dataclasses.fields(tengine.CompressionSpec)}
    j = {f.name for f in dataclasses.fields(jengine.CompressionSpec)}
    assert t == j - {"interpret"}
    for q in ("none", "bf16", "int8", "tern"):
        assert tengine.CompressionSpec(quantize=q).value_bits == \
            jengine.CompressionSpec(quantize=q).value_bits


# ------------------------------------------------------------ arith

def _exact_fma(a, b, c):
    """Correctly rounded float32 a*b + c, from exact rationals."""
    from fractions import Fraction
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    lo = np.float32(float(exact))           # within one f32 ulp of exact
    cands = [lo, np.nextafter(lo, np.float32(-np.inf)),
             np.nextafter(lo, np.float32(np.inf))]
    best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.float32(v).view(np.int32)) & 1))
    return np.float32(best)


def test_fma_is_correctly_rounded():
    from repro_torch.arith import fma, rcp
    # exact = (2**24 + 2**13 + 1) + 2**-40: a float64 sum rounds it onto the
    # float32 midpoint, and a second rounding to even would go down
    got = fma(torch.tensor([4097.0]), torch.tensor([4097.0]),
              torch.tensor([2.0 ** -40]))
    assert got.item() == 16785410.0
    rng = _rng("fma")
    a, b, c = (rng.normal(size=400).astype(np.float32) * s
               for s in (1.0, 1e3, 1e-2))
    got = fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    want = np.asarray([_exact_fma(*t) for t in zip(a, b, c)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert fma(0.7, torch.tensor([2.0]), 0.25).item() == \
        _exact_fma(np.float32(0.7), 2.0, 0.25)
    assert rcp(0.7) == float(np.float32(1) / np.float32(0.7))
