"""The port's batched event loop and its row-wise pieces on the CPU, against
the JAX reference and against the port's own serial loop.

Inputs are made once with numpy and fed to both packages.  With the
elementwise grad_fn of tests/test_torch_async_sim.py (grads = w - target)
the gradients are bit-equal in both frameworks, so whole runs are bit-equal
in final params, M, v and wire bytes; losses are reductions taken in other
orders and agree with the reference to 1e-6, and bit for bit between the
port's two loops.
"""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import async_sim as jsim
from repro.core import engine as jengine
from repro.core import make_strategy as jmake
from repro.cluster import wire as jwire
from repro.kernels import ops as jops
from repro.telemetry import metrics as jmetrics
from repro_torch import kernels as tkernels
from repro_torch.cluster import wire as twire
from repro_torch.convert import params_from_numpy
from repro_torch.core import async_sim as tsim
from repro_torch.core import engine as tengine
from repro_torch.core import make_strategy as tmake
from repro_torch.core.paramspace import ParamSpace as TSpace
from repro_torch.core.sparsify import SparseLeaf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import scatter_apply
from repro_torch.telemetry import Recorder
from repro_torch.telemetry import metrics as tmetrics

N_WORKERS, N_EVENTS = 5, 40


def _rng(*words):
    return np.random.default_rng(zlib.crc32(repr(words).encode()))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    return np.asarray(a)


def _equal(t, j):
    np.testing.assert_array_equal(_np(t), _np(j))


def _planted(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::5] = 0.75          # magnitude ties, both signs
    flat[2::9] = -0.75
    return x


# ------------------------------------------------------------ schedule

@pytest.mark.parametrize("n,e,seed,max_batch,cut_every", [
    (7, 200, 0, None, None), (9, 300, 2, 4, None), (9, 300, 2, None, 16),
    (9, 300, 2, 8, 24), (100, 96, 7, 16, None), (5, 40, 3, 1, 8)])
def test_batch_schedule_equal_to_reference(n, e, seed, max_batch, cut_every):
    sched = jsim.make_schedule(n, e, seed=seed, hetero=0.8)
    want = jsim.batch_schedule(sched, max_batch=max_batch,
                               cut_every=cut_every)
    got = tsim.batch_schedule(sched, max_batch=max_batch, cut_every=cut_every)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(got), sched)


# ------------------------------------------------------------ kernel 4

def _rows_problem(rng, n_rows, n, B, k):
    dense = rng.normal(size=(n_rows, n)).astype(np.float32)
    rows = rng.permutation(n_rows)[:B].astype(np.int32)
    idx = rng.integers(0, n, (B, k)).astype(np.int32)
    idx[0, ::3] = idx[0, 0]           # planted duplicates inside one row
    idx[-1, 1::4] = 7
    vals = (rng.normal(size=(B, k)) * 1e3).astype(np.float32)
    return dense, rows, idx, vals


@pytest.mark.parametrize("n_rows,n,B,k", [(6, 5000, 3, 40), (4, 2048, 4, 64),
                                          (9, 700, 2, 13), (3, 3000, 1, 50)])
def test_scatter_add_rows_equal_to_reference(n_rows, n, B, k):
    """The plain version of kernel 4 (what a CPU tensor takes) against the
    reference's scatter_add_rows (one XLA scatter off the TPU) and its
    blocked Pallas rows kernel in interpret mode, duplicates included."""
    dense, rows, idx, vals = _rows_problem(_rng("rows", n, k), n_rows, n, B, k)
    want = jops.scatter_add_rows(jnp.asarray(dense), jnp.asarray(rows),
                                 jnp.asarray(idx), jnp.asarray(vals))
    pallas = jops.scatter_apply_rows(jnp.asarray(dense[rows]),
                                     jnp.asarray(idx), jnp.asarray(vals),
                                     interpret=True)
    td = torch.from_numpy(dense.copy())
    out = tops.scatter_add_rows(td, rows, torch.from_numpy(idx),
                                torch.from_numpy(vals))
    assert out is td
    _equal(td, want)
    _equal(td[torch.from_numpy(rows).long()], pallas)
    # the order is ((d + v0) + v1) + ...: one run by hand
    b, j0 = 0, int(idx[0, 0])
    acc = np.float32(dense[rows[b], j0])
    for j in np.flatnonzero(idx[b] == j0):
        acc = np.float32(acc + vals[b, j])
    assert td[rows[b], j0].item() == acc


def test_scatter_add_rows_equals_a_loop_of_kernel_1_and_drops_out_of_range():
    rng = _rng("loop")
    dense, rows, idx, vals = _rows_problem(rng, 5, 900, 3, 30)
    idx[1, 4] = -1
    idx[2, 5] = 900
    got = tops.scatter_add_rows(torch.from_numpy(dense.copy()), rows,
                                torch.from_numpy(idx), torch.from_numpy(vals))
    want = torch.from_numpy(dense.copy())
    for b in range(3):
        ok = (idx[b] >= 0) & (idx[b] < 900)
        tops.scatter_add_row(want, int(rows[b]), torch.from_numpy(idx[b][ok]),
                             torch.from_numpy(vals[b][ok]))
    _equal(got, want)


@pytest.mark.parametrize("rows", [[1, 1], [0, 5], [-1, 2]])
def test_scatter_add_rows_refuses_bad_rows(rows):
    with pytest.raises(ValueError, match="rows"):
        tops.scatter_add_rows(torch.zeros(5, 10), rows,
                              torch.zeros((2, 3), dtype=torch.int32),
                              torch.ones(2, 3))


def test_scatter_add_rows_on_other_devices_raises():
    x = torch.empty((4, 1024), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        scatter_apply.scatter_add_rows_(
            x, [0, 1], torch.empty((2, 3), dtype=torch.int32, device="meta"),
            torch.empty((2, 3), device="meta"))


def test_scatter_add_rows_identity_rows_are_rows_0_to_b():
    """``rows=None`` (the blockwise repair's call) means lanes 0..B-1; the
    plain version takes it as the explicit rows."""
    dense, _, idx, vals = _rows_problem(_rng("ident"), 4, 600, 3, 25)
    idx[1, 3] = -2
    want = tops.scatter_add_rows(torch.from_numpy(dense.copy()), [0, 1, 2],
                                 torch.from_numpy(idx), torch.from_numpy(vals))
    got = tops.scatter_add_rows(torch.from_numpy(dense.copy()), None,
                                torch.from_numpy(idx), torch.from_numpy(vals))
    _equal(got, want)


@pytest.mark.parametrize("rows,lanes", [(None, 6), ([0, 1, 2], 2),
                                        ([3], 2)])
def test_scatter_add_rows_refuses_rows_that_do_not_fit_the_lanes(rows, lanes):
    with pytest.raises(ValueError, match="lanes"):
        tops.scatter_add_rows(torch.zeros(5, 10), rows,
                              torch.zeros((lanes, 3), dtype=torch.int32),
                              torch.ones(lanes, 3))


def test_kernel_constants_match_the_cuda_source():
    """The wrapper's launch count and the tests' round size follow the
    constants of csrc/scatter_apply.cu; the engine's switch to the row
    regime follows csrc/block_topk.cu's longest row a CTA holds."""
    import re
    from pathlib import Path

    from repro_torch.kernels import block_topk

    csrc = Path(scatter_apply.__file__).parent / "csrc"
    src = (csrc / "scatter_apply.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kMaxLanes"]) == scatter_apply.MAX_LANES
    assert int(consts["kCap"]) == scatter_apply.ROUND
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                             (csrc / "block_topk.cu").read_text()))
    assert int(consts["kRowMax"]) == block_topk.ROW_MAX
    assert int(consts["kSelectMaxR"]) == block_topk.SELECT_MAX_R


def test_rows_wrappers_take_the_plain_path_on_the_cpu(monkeypatch):
    from repro_torch.kernels import build

    def no_build(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(build, "library", no_build)
    tkernels.reset_launches()
    x = torch.randn(3, 3000)
    tops.hierarchical_topk_rows(x, k=10, r=4)
    tops.samomentum_fused_rows(x, x, torch.ones(3), momentum=0.7, lr=0.3)
    tops.scatter_add_rows(x.clone(), [2, 0], torch.ones((2, 4),
                                                       dtype=torch.int32),
                          torch.ones(2, 4))
    assert [info.launches for info in tkernels.KERNELS] == \
        [0] * len(tkernels.KERNELS)
    assert scatter_apply.ROWS_INFO in tkernels.KERNELS


# ------------------------------------------------------------ kernels 2, 3

@pytest.mark.parametrize("n,k,r", [(3000, 64, None), (8192, 655, 32),
                                   (5000, 40, 4), (100, 7, None)])
def test_hierarchical_topk_rows_equal_to_vmapped_reference(n, k, r):
    x = _planted(_rng("htr", n, k), (4, n))
    jv, ji = jax.vmap(functools.partial(jops.hierarchical_topk, k=k, r=r))(
        jnp.asarray(x))
    tv, ti = tops.hierarchical_topk_rows(torch.from_numpy(x), k=k, r=r)
    _equal(tv, jv)
    _equal(ti, ji)
    for b in range(4):                # and each row as the flat call
        fv, fi = tops.hierarchical_topk(torch.from_numpy(x[b]), k=k, r=r)
        _equal(tv[b], fv)
        _equal(ti[b], fi)


def test_samomentum_fused_rows_one_threshold_per_row():
    rng = _rng("samrows")
    u = rng.normal(size=(3, 2500)).astype(np.float32)
    g = rng.normal(size=(3, 2500)).astype(np.float32)
    thr = np.asarray([0.1, 0.6, 1e9], np.float32)
    to, tn = tops.samomentum_fused_rows(torch.from_numpy(u),
                                        torch.from_numpy(g),
                                        torch.from_numpy(thr), momentum=0.7,
                                        lr=0.1)
    for b in range(3):
        jo, jn = jops.samomentum_fused(jnp.asarray(u[b]), jnp.asarray(g[b]),
                                       jnp.float32(thr[b]), momentum=0.7,
                                       lr=0.1)
        _equal(to[b], jo)
        _equal(tn[b], jn)
    assert not to[2].any()


# ------------------------------------------------------------ engines

_ENGINE_SPECS = [("exact", None), ("sampled", None), ("blockwise", None),
                 ("blockwise", 4)]


@pytest.mark.parametrize("eng,block_r", _ENGINE_SPECS)
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_select_rows_equal_to_reference(eng, block_r, quantize):
    x = _planted(_rng("sel", eng, block_r), (3, 4000))
    jspec = jengine.CompressionSpec(engine=eng, quantize=quantize,
                                    block_r=block_r, sample_size=512)
    tspec = tengine.CompressionSpec(engine=eng, quantize=quantize,
                                    block_r=block_r, sample_size=512)
    jv, ji = jengine.select_rows(jnp.asarray(x), 40, jspec)
    tv, ti = tengine.select_rows(torch.from_numpy(x), 40, tspec)
    _equal(tv, jv)
    _equal(ti, ji)
    # the engine's own row-wise selection is its flat one on every row
    e = tengine.get_engine(eng, tspec)
    rv, ri = e.select_rows(torch.from_numpy(x), 40)
    for b in range(3):
        leaf = e.select(torch.from_numpy(x[b]), 40)
        _equal(rv[b], leaf.values)
        _equal(ri[b], leaf.indices)


@pytest.mark.parametrize("eng", ["exact", "sampled", "blockwise"])
def test_samomentum_step_rows_equal_to_reference(eng):
    rng = _rng("ssr", eng)
    u = rng.normal(size=(3, 3000)).astype(np.float32)
    g = rng.normal(size=(3, 3000)).astype(np.float32)
    jspec = jengine.CompressionSpec(engine=eng, sample_size=512)
    tspec = tengine.CompressionSpec(engine=eng, sample_size=512)
    want = jax.jit(functools.partial(jengine.samomentum_step_rows,
                                     momentum=0.7, lr=0.05, k=30,
                                     spec=jspec))(jnp.asarray(u),
                                                  jnp.asarray(g))
    got = tengine.samomentum_step_rows(torch.from_numpy(u),
                                       torch.from_numpy(g), momentum=0.7,
                                       lr=0.05, k=30, spec=tspec)
    for a, b in zip(got, want):
        _equal(a, b)
    mask = tengine.rows_support_mask(got[1], 3000)
    _equal(mask, jengine.rows_support_mask(want[1], 3000))


# ------------------------------------------------------------ strategies

def _params(rng):
    return {"w1": rng.normal(size=(12, 16)).astype(np.float32),
            "b1": np.zeros(16, np.float32),
            "w2": rng.normal(size=(16, 4)).astype(np.float32)}


_STEP_CONFIGS = [
    ("asgd", dict()),
    ("gd_async", dict(density=0.1)),
    ("dgs_plain", dict(density=0.2, engine="sampled")),
    ("dgc_async", dict(density=0.1)),
    ("dgc_async", dict(density=0.1, clip_norm=0.5)),
    ("dgs", dict(density=0.1)),
    ("dgs", dict(density=0.2, engine="sampled", quantize="tern")),
    ("dgs", dict(density=0.1, engine="blockwise", quantize="int8")),
]


@pytest.mark.parametrize("name,kw", _STEP_CONFIGS)
def test_step_rows_is_the_serial_step_on_every_row(name, kw):
    """Three steps of three workers with different learning rates: each row
    of ``step_rows`` is the serial ``step`` of that worker, bit for bit."""
    rng = _rng("steprows", name, repr(kw))
    p = params_from_numpy(_params(rng), "cpu")
    space = TSpace.from_tree(p)
    strat = tmake(name, **kw)
    serial = [strat.init(p) for _ in range(3)]
    from repro_torch.core.baselines import state_map
    stacked = state_map(lambda s: s.expand(3, *s.shape).contiguous(),
                        strat.init(p))
    for step in range(3):
        grads = [params_from_numpy({k: rng.normal(size=v.shape).astype(
            np.float32) for k, v in _params(rng).items()}, "cpu")
            for _ in range(3)]
        lrs = np.float32([0.05, 0.1, 0.013]) * np.float32(step + 1)
        g2d = torch.stack([space.pack(g) for g in grads])
        stacked, msgs = strat.step_rows(stacked, g2d, torch.from_numpy(lrs),
                                        space)
        for b in range(3):
            serial[b], msg = strat.step(serial[b], grads[b], float(lrs[b]))
            if isinstance(msg, SparseLeaf):
                _equal(msgs.values[b], msg.values)
                _equal(msgs.indices[b], msg.indices)
            else:
                _equal(msgs[b], msg)
    from repro_torch.core.baselines import state_tensors
    for b in range(3):
        for a, s in zip(state_tensors(stacked), state_tensors(serial[b])):
            _equal(a[b], s)


@pytest.mark.parametrize("mode", ["bf16", "int8", "tern"])
def test_quantize_message_rows_equal_to_vmapped_reference(mode):
    rng = _rng("qrows", mode)
    seg = (7, 12, 3)
    vals = rng.normal(size=(4, sum(seg))).astype(np.float32)
    idx = np.tile(np.arange(sum(seg), dtype=np.int32), (4, 1))
    jmsg = jax.vmap(lambda v, i: jwire.quantize_message(
        jsim.SparseLeaf(values=v, indices=i, size=100), mode, seg=seg))(
        jnp.asarray(vals), jnp.asarray(idx))
    tmsg = twire.quantize_message(
        SparseLeaf(values=torch.from_numpy(vals), indices=torch.from_numpy(idx),
                   size=100), mode, seg=seg)
    _equal(tmsg.values, jmsg.values)
    for b in range(4):                # each row as the serial quantizer
        one = twire.quantize_message(
            SparseLeaf(values=torch.from_numpy(vals[b]),
                       indices=torch.from_numpy(idx[b]), size=100),
            mode, seg=seg)
        _equal(tmsg.values[b], one.values)


# ------------------------------------------------------------ whole runs

def _problem(seed=0):
    rng = np.random.default_rng(seed)
    params = _params(rng)
    pool = [{k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()} for _ in range(N_EVENTS)]
    return params, pool


def _jax_grad_fn(p, t):
    grads = jax.tree.map(lambda w, x: w - x, p, t)
    loss = sum(jnp.mean(g ** 2) for g in jax.tree.leaves(grads))
    return loss, grads


def _torch_grad_fn(p, t):
    grads = {k: p[k] - t[k] for k in p}
    loss = sum(torch.mean(g ** 2) for g in grads.values())
    return loss, grads


def _spec(cls, eng, dq):
    kw = {"block_r": 4} if eng == "blockwise" else {}
    return cls(engine=eng, quantize=dq, **kw)


def _trainers(name, kw, sec, dq, eng):
    jtr = jsim.AsyncTrainer(jmake(name, **kw), _jax_grad_fn, N_WORKERS,
                            lr=0.05, secondary_density=sec,
                            secondary_spec=_spec(jengine.CompressionSpec,
                                                 eng, dq))
    ttr = tsim.AsyncTrainer(tmake(name, **kw), _torch_grad_fn, N_WORKERS,
                            lr=0.05, secondary_density=sec,
                            secondary_spec=_spec(tengine.CompressionSpec,
                                                 eng, dq), device="cpu")
    return jtr, ttr


def _assert_bit_equal(a, b, *, losses_exact=True):
    (fa, sa, ha), (fb, sb, hb) = a, b
    _np_tree = (lambda f: {k: _np(v) for k, v in f.items()})
    na, nb = _np_tree(fa), _np_tree(fb)
    assert sorted(na) == sorted(nb)
    for key in na:
        np.testing.assert_array_equal(na[key], nb[key])
    _equal(sa.M, sb.M)
    _equal(sa.v, sb.v)
    assert (ha.up_bytes, ha.down_bytes) == (hb.up_bytes, hb.down_bytes)
    np.testing.assert_array_equal(ha.staleness, hb.staleness)
    if losses_exact:
        np.testing.assert_array_equal(ha.losses, hb.losses)
    else:
        np.testing.assert_allclose(ha.losses, hb.losses, rtol=1e-6)


# the reference's _PARITY_CONFIGS (tests/test_async_sim.py) plus a dgs
# worker on the blockwise engine with a blockwise block_r=4 server
_CONFIGS = [
    ("dgs", dict(density=0.1), 0.1, "int8", "exact"),
    ("dgs", dict(density=0.2), 0.15, "bf16", "sampled"),
    ("dgs", dict(density=0.1), 0.1, "tern", "blockwise"),
    ("dgc_async", dict(density=0.1), 0.1, "none", "exact"),
    ("asgd", dict(), None, "none", "exact"),
    ("gd_async", dict(density=0.1), 0.1, "int8", "exact"),
    ("dgs", dict(density=0.1, engine="blockwise", quantize="int8"), 0.1,
     "none", "blockwise"),
]


@pytest.mark.parametrize("name,kw,sec,dq,eng", _CONFIGS)
def test_run_batched_bit_equal_to_both_loops_of_both_packages(name, kw, sec,
                                                              dq, eng):
    """The port's run_batched == the port's run == the reference's serial
    run (losses to 1e-6) == the reference's run_batched, bit for bit in
    params, M, v and bytes.  dgc_async is held to the reference's serial
    run only: the reference's two loops disagree by an ulp there."""
    params, pool = _problem()
    sched = jsim.make_schedule(N_WORKERS, N_EVENTS, seed=3, hetero=0.8)
    jtr, ttr = _trainers(name, kw, sec, dq, eng)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tpool = [params_from_numpy(b, "cpu") for b in pool]
    tparams = params_from_numpy(params, "cpu")
    t_batched = ttr.run_batched(tparams, sched, lambda e, k: tpool[e])
    _assert_bit_equal(t_batched, ttr.run(tparams, sched,
                                         lambda e, k: tpool[e]))
    _assert_bit_equal(t_batched, jtr.run(jparams, sched,
                                         lambda e, k: pool[e]),
                      losses_exact=False)
    if name != "dgc_async":
        _assert_bit_equal(t_batched, jtr.run_batched(jparams, sched,
                                                     lambda e, k: pool[e]),
                          losses_exact=False)


@pytest.mark.parametrize("max_batch", [None, 1, 2])
def test_run_batched_with_lr_fn_eval_and_max_batch(max_batch):
    """The blockwise dgs worker with lr_fn, eval_every (batches cut at the
    eval points) and max_batch, against the port's serial run (and, once,
    the reference's serial run: its Pallas interpret mode is slow)."""
    params, pool = _problem(1)
    sched = jsim.make_schedule(N_WORKERS, N_EVENTS, seed=1, hetero=0.5)
    name, kw, sec, dq, eng = _CONFIGS[-1]
    jtr, ttr = _trainers(name, kw, sec, dq, eng)
    lr_fn = lambda e: 0.05 / (1 + 0.01 * e)  # noqa: E731
    tpool = [params_from_numpy(b, "cpu") for b in pool]
    tparams = params_from_numpy(params, "cpu")
    kw_run = dict(lr_fn=lr_fn, eval_every=8,
                  eval_fn=lambda m: float(m["w1"].double().sum()))
    tb = ttr.run_batched(tparams, sched, lambda e, k: tpool[e],
                         max_batch=max_batch, **kw_run)
    ts = ttr.run(tparams, sched, lambda e, k: tpool[e], **kw_run)
    _assert_bit_equal(tb, ts)
    assert tb[2].evals == ts[2].evals
    assert [e for e, _ in tb[2].evals] == [8, 16, 24, 32, 40]
    if max_batch is not None:
        return
    js = jtr.run({k: jnp.asarray(v) for k, v in params.items()}, sched,
                 lambda e, k: pool[e], lr_fn=lr_fn)
    _assert_bit_equal(tb, js, losses_exact=False)


def test_run_batched_max_batch_one_dgc_matches_serial():
    """The reference's own failing case (its dgc_async max_batch=1 run
    drifts by an ulp from its serial run): the port's two loops agree, and
    both equal the reference's serial run."""
    params, pool = _problem(2)
    sched = jsim.make_schedule(4, 24, seed=6, hetero=0.5)
    jtr = jsim.AsyncTrainer(jmake("dgc_async", density=0.1), _jax_grad_fn, 4,
                            lr=0.05, secondary_density=0.1)
    ttr = tsim.AsyncTrainer(tmake("dgc_async", density=0.1), _torch_grad_fn,
                            4, lr=0.05, secondary_density=0.1, device="cpu")
    tpool = [params_from_numpy(b, "cpu") for b in pool]
    tparams = params_from_numpy(params, "cpu")
    tb = ttr.run_batched(tparams, sched, lambda e, k: tpool[e], max_batch=1)
    _assert_bit_equal(tb, ttr.run(tparams, sched, lambda e, k: tpool[e]))
    _assert_bit_equal(tb, jtr.run({k: jnp.asarray(v)
                                   for k, v in params.items()}, sched,
                                  lambda e, k: pool[e]), losses_exact=False)


# ------------------------------------------------------------ telemetry

_METRICS_CONFIGS = [
    ("dgs", dict(density=0.1, quantize="int8"), 0.1),
    ("dgc_async", dict(density=0.1), 0.1),
    ("asgd", dict(), None),
]


@pytest.mark.parametrize("name,kw,sec", _METRICS_CONFIGS)
def test_metrics_change_no_bit_and_equal_the_reference(name, kw, sec):
    """metrics=True is bit-identical to metrics off in both loops, and the
    drained state equals the reference's for the same run.  The magnitude
    histogram bins a float sum (|G|^2) that the two frameworks add in other
    orders; the rule is that it must hold every event, and it must agree
    bucket for bucket unless a sum lies within an ulp of a power of two
    (it does not here)."""
    params, pool = _problem(3)
    sched = jsim.make_schedule(N_WORKERS, N_EVENTS, seed=3, hetero=0.8)
    jtr = jsim.AsyncTrainer(jmake(name, **kw), _jax_grad_fn, N_WORKERS,
                            lr=0.05, secondary_density=sec)
    ttr = tsim.AsyncTrainer(tmake(name, **kw), _torch_grad_fn, N_WORKERS,
                            lr=0.05, secondary_density=sec, device="cpu")
    tpool = [params_from_numpy(b, "cpu") for b in pool]
    tparams = params_from_numpy(params, "cpu")
    fn = lambda e, k: tpool[e]  # noqa: E731
    off = ttr.run(tparams, sched, fn)
    on = ttr.run(tparams, sched, fn, metrics=True)
    b_off = ttr.run_batched(tparams, sched, fn)
    b_on = ttr.run_batched(tparams, sched, fn, metrics=True)
    for other in (on, b_off, b_on):
        _assert_bit_equal(off, other)
    assert off[2].metrics is None and b_off[2].metrics is None
    md = on[2].metrics
    assert md == b_on[2].metrics
    assert md["n_events"] == N_EVENTS
    assert md["per_worker"] == np.bincount(sched,
                                           minlength=N_WORKERS).tolist()
    assert md["staleness_hist"] == tmetrics.summarize_log2(on[2].staleness)
    assert sum(md["update_mag_hist"]["counts"]) == N_EVENTS
    _, _, jh = jtr.run({k: jnp.asarray(v) for k, v in params.items()}, sched,
                       lambda e, k: pool[e], metrics=True)
    assert md == jh.metrics


@pytest.mark.parametrize("x", [[0, 1, 2, 3, 6, 7, 1000, 2 ** 20],
                               [5, 0, 2 ** 24, 2 ** 30]])
def test_log2_and_mag_bins_equal_the_reference(x):
    xa = np.asarray(x, np.int32)
    _equal(tmetrics.log2_bin(torch.from_numpy(xa)), jmetrics.log2_bin(xa))
    sq = np.asarray([0.0, 1e-20, 2.0 ** -40, 0.3, 1.0, 2.0, 3.9, 2.0 ** 30],
                    np.float32)
    _equal(tmetrics.mag_bin(torch.from_numpy(sq)),
           jmetrics.mag_bin(jnp.asarray(sq)))
    assert tmetrics.summarize_log2(xa) == jmetrics.summarize_log2(xa)


def test_recorder_traces_both_loops(tmp_path):
    import json

    params, pool = _problem(4)
    sched = jsim.make_schedule(N_WORKERS, 16, seed=4, hetero=0.8)
    ttr = tsim.AsyncTrainer(tmake("dgs", density=0.1), _torch_grad_fn,
                            N_WORKERS, lr=0.05, secondary_density=0.1,
                            device="cpu")
    tpool = [params_from_numpy(b, "cpu") for b in pool]
    tparams = params_from_numpy(params, "cpu")
    for runner, loop in (("serial", ttr.run), ("batched", ttr.run_batched)):
        with Recorder(tmp_path / runner) as rec:
            loop(tparams, sched, lambda e, k: tpool[e], recorder=rec,
                 eval_every=8, eval_fn=lambda m: 0.5)
        trace = json.loads((tmp_path / runner / "trace.json").read_text())
        names = {ev["name"] for ev in trace["traceEvents"]}
        prefix = "sim" if runner == "serial" else "batched"
        assert {f"{prefix}/commit", f"{prefix}/apply",
                f"{prefix}/eval"} <= names
        events = [json.loads(line) for line in
                  (tmp_path / runner / "events.jsonl").read_text().split("\n")
                  if line]
        kinds = [ev["kind"] for ev in events]
        assert kinds.count("eval") == 2 and kinds[-1] == "run_summary"
        assert events[-1]["runner"] == runner
        assert events[-1]["n_events"] == 16


# ------------------------------------------------------------ device rule

def test_params_from_numpy_follows_the_device_rule():
    tree = {"w": np.ones((2, 3), np.float32), "b": {"z": np.zeros(2)}}
    out = params_from_numpy(tree, "cpu")
    assert list(out) == ["b", "w"] and out["w"].device.type == "cpu"
    assert out["b"]["z"].dtype == torch.float64
    if torch.cuda.is_available():
        assert params_from_numpy(tree)["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            params_from_numpy(tree)
