"""The port's kernel modules on the CPU, against the JAX reference.

On a CPU tensor every kernel wrapper runs its plain PyTorch version, and
that version must equal the reference's Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) bit for bit: SAMomentum outputs, top-k
values and indices, scatters.  The CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py.
"""
import zlib
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.block_topk import block_topk_2d as jblock_topk_2d
from repro_torch.kernels import block_topk, build, samomentum_kernel
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import reset_launches, scatter_apply

SHAPES = [(100,), (4096,), (333, 7), (8, 1024), (2, 3, 1000)]
DTYPES = [np.float32, "bfloat16"]


def _rng(*words):
    return np.random.default_rng(zlib.crc32(repr(words).encode()))


def _pair(x, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t
    return jnp.asarray(x), torch.from_numpy(x)


def _np(a):
    """float32 numpy of a jax array or torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    return np.asarray(a, np.float32) if jnp.issubdtype(a.dtype,
                                                       jnp.floating) \
        else np.asarray(a)


def _equal(t, j):
    np.testing.assert_array_equal(_np(t), _np(j))


def _bits_equal(t, j):
    """float32 bit patterns equal: -0 and +0 differ."""
    np.testing.assert_array_equal(_np(t).view(np.int32), _np(j).view(np.int32))


# ------------------------------------------------------------ SAMomentum

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_samomentum_fused_bit_equal(shape, dtype):
    rng = _rng("sam", shape, str(dtype))
    ju, tu = _pair(rng.normal(size=shape).astype(np.float32), dtype)
    jg, tg = _pair(rng.normal(size=shape).astype(np.float32), dtype)
    for thr in (0.5, 0.0, 1e9):
        jo, jn = jops.samomentum_fused(ju, jg, jnp.float32(thr),
                                       momentum=0.7, lr=0.1)
        to, tn = tops.samomentum_fused(tu, tg, thr, momentum=0.7, lr=0.1)
        assert to.dtype == tu.dtype and to.shape == tu.shape
        _equal(to, jo)
        _equal(tn, jn)


@pytest.mark.parametrize("m", [0.7, 0.9, 0.05094047])
def test_samomentum_fused_uacc_uacc_call_and_planted_threshold(m):
    """The blockwise step's call, (uacc, uacc, lr=1-m), with thr planted on
    an element (the >= tie) -- evaluated, not shortcut to uacc."""
    rng = _rng("uacc", m)
    x = rng.normal(size=5000).astype(np.float32)
    to, _ = tops.samomentum_fused(torch.from_numpy(x), torch.from_numpy(x),
                                  0.0, momentum=m, lr=1.0 - m)
    thr = float(abs(to[17]))
    jo, jn = jops.samomentum_fused(jnp.asarray(x), jnp.asarray(x),
                                   jnp.float32(thr), momentum=m, lr=1.0 - m)
    to, tn = tops.samomentum_fused(torch.from_numpy(x), torch.from_numpy(x),
                                   thr, momentum=m, lr=1.0 - m)
    assert to[17] != 0
    _equal(to, jo)
    _equal(tn, jn)


def test_samomentum_kernel_within_an_ulp_of_the_eager_oracle():
    """ref.py runs op by op (one rounding each), the kernel in the fused
    forms; they agree to rounding, away from the threshold."""
    rng = _rng("oracle")
    u = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    out, unew = tops.samomentum_fused(u, g, 0.5, momentum=0.7, lr=0.1)
    r_out, r_unew, _ = tref.samomentum_ref(u, g, 0.5, momentum=0.7, lr=0.1)
    np.testing.assert_allclose(out.numpy(), r_out.numpy(), rtol=3e-7,
                               atol=1e-7)
    np.testing.assert_allclose(unew.numpy(), r_unew.numpy(), rtol=3e-7,
                               atol=1e-7)


# ------------------------------------------------------------ the FMAs

F32_MAX = float(np.finfo(np.float32).max)
# a float32 result at or beyond this magnitude rounds to infinity
F32_OVERFLOW = Fraction(2) ** 128 - Fraction(2) ** 103


def _exact_fma(a, b, c):
    """float32 ``a * b + c`` rounded once, to nearest even, from exact
    rationals (IEEE signs of zero, underflow to denormals and overflow to
    infinity); non-finite operands or products through float64, where no
    rounding is left to get wrong."""
    a, b, c = (np.float32(x) for x in (a, b, c))
    if not all(np.isfinite([a, b, c])):
        with np.errstate(invalid="ignore", over="ignore"):
            return np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    prod = Fraction(float(a)) * Fraction(float(b))
    exact = prod + Fraction(float(c))
    if exact == 0:
        # an exact zero is -0 only as (-0) + (-0)
        neg = prod == 0 and np.signbit(a) != np.signbit(b) and np.signbit(c)
        return np.float32(-0.0 if neg else 0.0)
    if abs(exact) >= F32_OVERFLOW:
        return np.float32(np.copysign(np.inf, float(exact)))
    lo = np.float32(float(exact))      # within an ulp of the exact value
    with np.errstate(over="ignore"):
        cands = [lo, np.nextafter(lo, np.float32(-np.inf)),
                 np.nextafter(lo, np.float32(np.inf))]
    cands = [x for x in cands if np.isfinite(x)]
    best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.float32(v).view(np.int32)) & 1))
    if best == 0:                       # underflow keeps the sign
        return np.float32(np.copysign(0.0, float(exact)))
    return np.float32(best)


def _halfway_cases(rng, size):
    """float32 (a, b, c) whose exact a * b + c lies far within an ulp of a
    point halfway between two float32 values (a float64 rounding first
    would land on it): a * b an odd integer in [2^24, 2^25) plus a c of
    2^-30 to 2^-60 of it, and 64 - 2^-40 beside a c in [2^30, 2^31) with an
    odd last bit; scaled by powers of two, signs at random."""
    h = size // 2
    a = np.concatenate([rng.integers(2048, 2896, h) * 2 + 1.0,
                        np.full(size - h, 8.0 + 2.0 ** -20)])
    b = np.concatenate([rng.integers(2048, 2896, h) * 2 + 1.0,
                        np.full(size - h, 8.0 - 2.0 ** -20)])
    c = np.concatenate([np.ldexp(1.0, -rng.integers(30, 60, h)),
                        (2.0 ** 23 + rng.integers(0, 2 ** 22, size - h) * 2
                         + 1) * 128.0])
    s1, s2 = rng.integers(-40, 40, size), rng.integers(-40, 40, size)
    a, b, c = np.ldexp(a, s1), np.ldexp(b, s2), np.ldexp(c, s1 + s2)
    sign = rng.choice([-1.0, 1.0], (3, size))
    return tuple((x * sg).astype(np.float32) for x, sg in zip((a, b, c), sign))


_INF, _NAN, _T = float("inf"), float("nan"), 2.0 ** -70
# (a, b, c, a * b + c rounded once)
_SPECIAL = [(-0.0, 3.0, -0.0, -0.0), (0.0, -3.0, -0.0, -0.0),
            (-0.0, -3.0, 0.0, 0.0), (3.0, 0.0, -0.0, 0.0),
            (_T, _T, 0.0, 2.0 ** -140), (_T, -_T, 2.0 ** -149,
                                         -511 * 2.0 ** -149),
            (2.0 ** -75, 2.0 ** -75, -0.0, 0.0),       # 2^-150: a tie, to 0
            (2.0 ** -75, -2.0 ** -74, 0.0, -2.0 ** -149),
            (2.0 ** 64, 2.0 ** 64, 0.0, _INF),
            (F32_MAX, 1.0, F32_MAX * 2.0 ** -24, _INF),
            (F32_MAX, 1.0, F32_MAX * 2.0 ** -25, F32_MAX),
            (_INF, 0.0, 1.0, _NAN), (_INF, 2.0, -_INF, _NAN),
            (_INF, 2.0, 5.0, _INF), (-_INF, 2.0, 5.0, -_INF),
            (2.0, 3.0, _INF, _INF), (_NAN, 1.0, 2.0, _NAN),
            (1.0, 2.0, _NAN, _NAN), (1e30, 1e10, -_INF, -_INF)]


def _bits_nan(x):
    """float32 bit patterns, every NaN as one."""
    x = np.asarray(x, np.float32)
    return np.where(np.isnan(x), 0x7FC00000, x.view(np.int32))


def test_exact_fma_oracle_on_the_special_table():
    for a, b, c, want in _SPECIAL:
        np.testing.assert_array_equal(_bits_nan(_exact_fma(a, b, c)),
                                      _bits_nan(want), err_msg=str((a, b, c)))


@pytest.mark.parametrize("case", ["halfway", "special"])
def test_fma_plain_is_correctly_rounded_on_hard_cases(case):
    """The plain version of the fma kernel (``arith.fma``'s float64
    round-to-odd emulation) against exact rationals, bit for bit, where a
    double rounding would err and at IEEE corner cases."""
    if case == "halfway":
        a, b, c = _halfway_cases(_rng("halfway"), 400)
    else:
        a, b, c = (np.asarray(col, np.float32)
                   for col in list(zip(*_SPECIAL))[:3])
    got = samomentum_kernel.fused_multiply_add(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    want = [_exact_fma(*t) for t in zip(a, b, c)]
    np.testing.assert_array_equal(_bits_nan(got.numpy()), _bits_nan(want))
    # a float64 sum rounded again to float32 errs on the halfway cases
    if case == "halfway":
        twice = (a.astype(np.float64) * b + c).astype(np.float32)
        assert (twice.view(np.int32) != np.asarray(want).view(np.int32)).any()


@pytest.mark.parametrize("lr", ["float", "rows"])
def test_velocity_accumulate_plain_is_one_rounding_of_m_u_plus_lr_g(lr):
    """fma(m, u, lr * g): lr * g rounded to float32, then one rounding of
    the fused sum -- on halfway cases (m * u an odd integer in
    [2^24, 2^25)), on strided leaf views, lr a float or a (B, 1)
    column."""
    rng = _rng("acc", lr)
    B, n = 3, 300
    u = (rng.integers(2048, 2896, (B, n)) * 2 + 1.0).astype(np.float32)
    g = (np.ldexp(1.0, -rng.integers(6, 36, (B, n)))
         * rng.choice([-1.0, 1.0], (B, n))).astype(np.float32)
    g[:, ::7] = rng.normal(size=g[:, ::7].shape)
    lrs = np.asarray([1.0, 0.5, 0.1], np.float32)[:, None]
    arg = {"float": 1.0, "rows": torch.from_numpy(lrs)}[lr]
    lr_np = {"float": np.ones((B, 1), np.float32), "rows": lrs}[lr]
    arena = torch.zeros(2, B, n + 9)
    arena[0, :, 5:5 + n], arena[1, :, 5:5 + n] = (torch.from_numpy(u),
                                                  torch.from_numpy(g))
    got = samomentum_kernel.velocity_accumulate(
        arena[0, :, 5:5 + n], arena[1, :, 5:5 + n], momentum=4097.0, lr=arg)
    assert got.is_contiguous() and got.shape == (B, n)
    lrg = lr_np * g                       # float32 products, one rounding
    want = np.vectorize(_exact_fma)(np.float32(4097.0), u, lrg)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.astype(np.float32).view(np.int32))


def test_fma_wrappers_take_the_plain_path_on_the_cpu(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(build, "library", no_build)
    reset_launches()
    x = torch.randn(3, 50)
    samomentum_kernel.velocity_accumulate(x, x, momentum=0.7,
                                          lr=torch.ones(3, 1))
    samomentum_kernel.fused_multiply_add(x, 0.5, x)
    assert samomentum_kernel.ACC_INFO.launches == 0
    assert samomentum_kernel.FMA_INFO.launches == 0


def test_fma_operand_forms():
    """The C entries' operand descriptors: (pointer, row stride, value,
    kind) for floats, columns and full views."""
    op = samomentum_kernel._operand
    SCALAR, ROW, FULL = (samomentum_kernel.SCALAR, samomentum_kernel.ROW,
                         samomentum_kernel.FULL)
    arena = torch.zeros(3, 101)
    view = arena[:, 7:57]
    shape = view.shape
    assert op(0.25, shape, view.device, "x") == (None, 0, 0.25, SCALAR)
    assert op(view, shape, view.device, "x") == \
        (view.data_ptr(), 101, 0.0, FULL)
    col = torch.ones(3, 1)
    assert op(col, shape, col.device, "x") == (col.data_ptr(), 1, 0.0, ROW)
    flat = torch.ones(40)
    assert op(flat, flat.shape, flat.device, "x")[3] == FULL
    assert samomentum_kernel._rows((3, 50)) == (3, 50)
    assert samomentum_kernel._rows((2, 3, 4)) == (1, 24)
    assert samomentum_kernel._rows(()) == (1, 1)


@pytest.mark.parametrize("bad", ["transposed", "row", "shape", "dtype",
                                 "strided 1-d", "one element"])
def test_fma_operand_forms_refused(bad):
    """Operands are a float, a (B, 1) column or a tensor of the result's
    shape: a row, another shape, a transposed or strided 1-d view, another
    dtype and a one-element tensor against a (3, 50) result are refused."""
    op = samomentum_kernel._operand
    shape = torch.Size((3, 50))
    x = {"transposed": torch.zeros(50, 3).t(), "row": torch.zeros(1, 50),
         "shape": torch.zeros(3, 49), "dtype": torch.zeros(3, 50,
                                                           dtype=torch.float64),
         "strided 1-d": torch.zeros(100)[::2],
         "one element": torch.tensor(2.0)}[bad]
    with pytest.raises(TypeError if bad == "dtype" else ValueError):
        op(x, shape if bad != "strided 1-d" else x.shape, x.device, "x")


def test_fma_wrappers_on_other_devices_raise():
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        samomentum_kernel.fused_multiply_add(x, 0.5, x)
    with pytest.raises(ValueError, match="no kernel"):
        samomentum_kernel.velocity_accumulate(x, x, momentum=0.7, lr=0.1)
    with pytest.raises(TypeError, match="no tensor"):
        samomentum_kernel.fused_multiply_add(1.0, 2.0, 3.0)


# ------------------------------------------------------------ block top-k

def _planted(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = 0.5          # magnitude ties, both signs
    flat[3::11] = -0.5
    flat[: min(64, flat.size)] = 0.0
    return x


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("r", [1, 4, 16])
def test_block_topk_candidates_bit_equal(shape, r):
    x = _planted(_rng("bt", shape, r), shape)
    jv, ji = jops.block_topk_candidates(jnp.asarray(x), r=r)
    tv, ti = tops.block_topk_candidates(torch.from_numpy(x), r=r)
    _equal(tv, jv)
    _equal(ti, ji)
    rv, ri = jref.block_topk_ref(jnp.asarray(x), block=1024, r=r)
    _equal(tv[:rv.shape[0]], rv)      # the oracle pads to one block only
    _equal(ti[:ri.shape[0]], ri)


@pytest.mark.parametrize("n,k,r", [(512, 16, None), (3000, 64, None),
                                   (8192, 128, None), (8192, 655, 32),
                                   (5000, 40, 4)])
def test_hierarchical_topk_bit_equal(n, k, r):
    x = _planted(_rng("ht", n, k), (n,))
    jv, ji = jops.hierarchical_topk(jnp.asarray(x), k=k, r=r)
    tv, ti = tops.hierarchical_topk(torch.from_numpy(x), k=k, r=r)
    _equal(tv, jv)
    _equal(ti, ji)


def test_block_topk_bf16_plain_matches_reference_oracle():
    """bf16 input: the reference's Pallas kernel refuses bf16 in interpret
    mode (it stores the f32 cast), so the oracle of ref.py is the bar."""
    x = _planted(_rng("bf"), (3, 1024))
    jx, tx = _pair(x, "bfloat16")
    rv, ri = jref.block_topk_ref(jx, block=1024, r=8)
    tv, ti = tops.block_topk_candidates(tx, r=8)
    assert tv.dtype == torch.bfloat16
    _equal(tv[:3], rv)
    _equal(ti[:3], ri)


def _adversarial_blocks(rng):
    """One reference group of 8 blocks for the kernel's two regimes.  Rows
    0-5: all equal at a power of two, zeros of both signs, magnitude ties
    across the lane and register boundaries of the kernel's layout (element
    128 q + 4 lane + c), small integers (ties at every rank), mostly zeros
    with infinities, and all equal off a power of two.  Rows 6-7: denormals
    (multiples of 1e-41 and the smallest, both signs) among zeros, row 7
    with normal values mixed in."""
    x = rng.normal(size=(8, 1024)).astype(np.float32)
    sign = np.where(rng.random(1024) < 0.5, -1.0, 1.0).astype(np.float32)
    x[0] = 0.5
    x[1] = np.float32(0.0) * sign
    pos = np.asarray([0, 3, 4, 31, 32, 33, 127, 128, 129, 511, 512, 513,
                      1020, 1023])
    x[2, pos] = 3.0 * sign[pos]
    x[2, pos[:-1] + 1] = 2.5 * sign[pos[:-1]]
    x[3] = np.round(x[3] * 2)
    x[4] = 0.0
    x[4, ::50] = rng.normal(size=21).astype(np.float32)
    x[4, [5, 700, 701]] = [np.inf, -np.inf, np.inf]
    x[5] = -0.3
    x[6:] = rng.integers(0, 5, (2, 1024)).astype(np.float32) \
        * np.float32(1e-41) * sign
    x[6:, ::9] = np.float32(1e-45) * sign[::9]
    x[7, ::50] = rng.normal(size=21).astype(np.float32)
    return x


@pytest.mark.parametrize("r", [1, 2, 31, 32, 33, block_topk.SELECT_MAX_R,
                               block_topk.SELECT_MAX_R + 1, 1023, 1024])
def test_block_topk_adversarial_blocks_bit_equal(r):
    """The plain version (the CUDA kernel's yardstick) against the
    reference's Pallas kernel in interpret mode, around the kernel's regime
    switch and at the full block.  The reference runs on XLA's CPU, which
    compares denormals as zero: on the denormal blocks it equals the port
    on the input flushed to +-0 (the port ranks denormals by magnitude, the
    sign-cleared bit pattern, as its kernel does)."""
    x = _adversarial_blocks(_rng("adv", r))
    jv, ji = jblock_topk_2d(jnp.asarray(x), r=r)
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = block_topk.block_topk_2d(torch.from_numpy(x), r=r)
    _bits_equal(tv[:6], jv[:6])
    _equal(ti[:6], ji[:6])
    # denormals: the port's order is the bit pattern's ...
    den = x[6:]
    mag = den.view(np.int32) & 0x7fffffff
    want = np.argsort(-mag.astype(np.int64), axis=1, kind="stable")[:, :r]
    np.testing.assert_array_equal(ti[6:].numpy(), want)
    _bits_equal(tv[6:], np.take_along_axis(den, want, 1))
    # ... and the reference's is the port's on the flushed input
    tiny = np.abs(den) < np.float32(2.0 ** -126)
    flushed = np.where(tiny, np.float32(0.0) * np.sign(den), den)
    _, fi = block_topk.block_topk_2d(torch.from_numpy(flushed), r=r)
    _equal(fi, ji[6:])
    _bits_equal(np.take_along_axis(den, ji[6:], 1), jv[6:])


# ------------------------------------------------------------ scatter-add

@pytest.mark.parametrize("n,k", [(1000, 10), (5000, 200), (8192, 64),
                                 (100000, 1000)])
def test_scatter_add_unique_bit_equal(n, k):
    rng = _rng("sc", n, k)
    dense = rng.normal(size=n).astype(np.float32)
    idx = rng.permutation(n)[:k].astype(np.int32)
    vals = rng.normal(size=k).astype(np.float32)
    want = jops.scatter_apply(jnp.asarray(dense), jnp.asarray(idx),
                              jnp.asarray(vals))
    got = tops.scatter_add(torch.from_numpy(dense.copy()),
                           torch.from_numpy(idx), torch.from_numpy(vals))
    _equal(got, want)


@pytest.mark.parametrize("cap", [None, 2])
def test_scatter_add_duplicates_sum_in_update_order(cap):
    rng = _rng("dup", cap)
    n = 4096
    dense = rng.normal(size=n).astype(np.float32)
    idx = np.asarray([5, 5, 5, 5, 2100, 7, 5, 2100, 0], np.int32)
    vals = (rng.normal(size=idx.size) * 1e3).astype(np.float32)
    want = jops.scatter_apply(jnp.asarray(dense), jnp.asarray(idx),
                              jnp.asarray(vals), cap=cap)
    got = tops.scatter_add(torch.from_numpy(dense.copy()),
                           torch.from_numpy(idx), torch.from_numpy(vals))
    _equal(got, want)
    _equal(got, jref.scatter_accumulate_ref(jnp.asarray(dense),
                                            jnp.asarray(idx),
                                            jnp.asarray(vals)))
    # the order is ((d + v0) + v1) + ...: check one run by hand
    acc = np.float32(dense[5])
    for j in np.flatnonzero(idx == 5):
        acc = np.float32(acc + vals[j])
    assert got[5].item() == acc


SCATTER_CASES = ["all on one index", "all in one range",
                 "duplicates across round boundaries", "out-of-range indices",
                 "-0 runs and +0 pads", "k=0", "k=1"]


def _scatter_case(case, rng, n):
    """(dense, indices, values) for one adversarial case of the flat
    scatter-add; the kernel applies at most ``scatter_apply.ROUND`` kept
    updates per CTA round, so the long cases span several rounds."""
    rnd = scatter_apply.ROUND
    dense = rng.normal(size=n).astype(np.float32)
    if case == "all on one index":
        idx = np.full(2 * rnd + 17, 1234)
    elif case == "all in one range":
        idx = rng.integers(0, 300, 3 * rnd)
    elif case == "duplicates across round boundaries":
        idx = rng.integers(n - 400, n, 2 * rnd + 5)
        idx[rnd - 1:rnd + 1] = idx[2 * rnd - 1:2 * rnd + 1] = n - 7
    elif case == "out-of-range indices":
        idx = rng.integers(0, n, 600)
        idx[::5] = n + np.arange(idx[::5].size)
        idx[3] = 2**31 - 1
    elif case == "-0 runs and +0 pads":
        # the sampled engine pads a message with its strongest index at
        # value 0: (-0 + -0) + 0 is +0, so the pads must be applied
        dense[:60] = -0.0
        idx = np.concatenate([np.arange(50), np.arange(50), np.arange(50, 60),
                              rng.integers(60, n, 300), np.zeros(16, int)])
        vals = np.concatenate([np.full(50, -0.0), np.zeros(50),
                               np.full(10, -0.0), rng.normal(size=300),
                               np.zeros(16)]).astype(np.float32)
        return dense, idx.astype(np.int32), vals
    else:
        idx = rng.integers(0, n, int(case[2:]))
    vals = (rng.normal(size=idx.size) * 1e3).astype(np.float32)
    return dense, idx.astype(np.int32), vals


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_scatter_add_adversarial_bit_equal(case):
    """The plain version (the CUDA kernel's yardstick) against the
    reference's scatter, bit for bit: in-order duplicate sums within and
    across the kernel's rounds, out-of-range indices dropped, -0 kept."""
    dense, idx, vals = _scatter_case(case, _rng("scadv", case), 5000)
    want = jops.scatter_add(jnp.asarray(dense), jnp.asarray(idx),
                            jnp.asarray(vals))
    got = tops.scatter_add(torch.from_numpy(dense.copy()),
                           torch.from_numpy(idx), torch.from_numpy(vals))
    _bits_equal(got, want)
    if case == "all on one index":
        acc = np.float32(dense[1234])
        for v in vals:
            acc = np.float32(acc + v)
        assert got[1234].item() == acc
    if case == "-0 runs and +0 pads":
        assert np.signbit(got[50:60].numpy()).all()
        assert not np.signbit(got[1:50].numpy()).any()


def test_scatter_add_drops_negative_indices():
    """The port drops every index outside [0, n), as its kernel does.  The
    reference's XLA scatter drops those at or above n but wraps [-n, -1]
    (numpy indexing), so it is held to the port without them."""
    rng = _rng("neg")
    n = 3000
    dense = rng.normal(size=n).astype(np.float32)
    idx = rng.integers(-n - 50, n + 50, 900).astype(np.int32)
    vals = rng.normal(size=900).astype(np.float32)
    ok = (idx >= 0) & (idx < n)
    want = jops.scatter_add(jnp.asarray(dense), jnp.asarray(idx[ok]),
                            jnp.asarray(vals[ok]))
    got = tops.scatter_add(torch.from_numpy(dense.copy()),
                           torch.from_numpy(idx), torch.from_numpy(vals))
    _bits_equal(got, want)


def test_scatter_add_row_bit_equal_and_in_place():
    rng = _rng("row")
    v = rng.normal(size=(4, 700)).astype(np.float32)
    idx = rng.permutation(700)[:13].astype(np.int32)
    vals = rng.normal(size=13).astype(np.float32)
    want = jops.scatter_add_row(jnp.asarray(v), 2, jnp.asarray(idx),
                                jnp.asarray(vals))
    tv = torch.from_numpy(v.copy())
    out = tops.scatter_add_row(tv, 2, torch.from_numpy(idx),
                               torch.from_numpy(vals))
    assert out is tv
    _equal(tv, want)


# ------------------------------------------------------------ oracles

def test_ref_oracles_match_reference_oracles():
    rng = _rng("ref")
    u = rng.normal(size=3000).astype(np.float32)
    g = rng.normal(size=3000).astype(np.float32)
    for a, b in zip(tref.samomentum_ref(torch.from_numpy(u),
                                        torch.from_numpy(g), 0.5,
                                        momentum=0.7, lr=0.1),
                    jref.samomentum_ref(jnp.asarray(u), jnp.asarray(g),
                                        jnp.float32(0.5), momentum=0.7,
                                        lr=0.1)):
        _equal(a, b)
    x = _planted(rng, (2500,))
    for a, b in zip(tref.block_topk_ref(torch.from_numpy(x), block=1024, r=5),
                    jref.block_topk_ref(jnp.asarray(x), block=1024, r=5)):
        _equal(a, b)
    idx = np.asarray([1, 1, 3], np.int32)
    vals = np.asarray([1.0, 2.0, 4.0], np.float32)
    out = tref.scatter_accumulate_ref(torch.zeros(8), torch.from_numpy(idx),
                                      torch.from_numpy(vals))
    np.testing.assert_array_equal(out.numpy(), [0, 3, 0, 4, 0, 0, 0, 0])


# ------------------------------------------------------------ dispatch

def test_cpu_tensors_take_the_plain_path_without_nvcc(monkeypatch):
    """No kernel is built or counted for a CPU tensor."""
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(build, "library", no_build)
    monkeypatch.setattr(build, "build", no_build)
    reset_launches()
    x = torch.randn(3000)
    tops.hierarchical_topk(x, k=10, r=4)
    tops.samomentum_fused(x, x, 0.1, momentum=0.7, lr=0.3)
    tops.scatter_add(x.clone(), torch.tensor([1, 2], dtype=torch.int32),
                     torch.ones(2))
    assert [info.launches for info in (scatter_apply.INFO, block_topk.INFO,
                                       samomentum_kernel.INFO)] == [0, 0, 0]


def test_other_devices_raise_and_never_fall_back():
    x = torch.empty(1024, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        block_topk.block_topk_2d(x.reshape(1, 1024), r=4)
    with pytest.raises(ValueError, match="no kernel"):
        samomentum_kernel.samomentum_fused_flat(x, x, torch.empty(
            1, device="meta"), momentum=0.7, lr=0.1)
    with pytest.raises(ValueError, match="no kernel"):
        scatter_apply.scatter_add_(x, torch.empty(3, dtype=torch.int32,
                                                  device="meta"),
                                   torch.empty(3, device="meta"))


@pytest.mark.parametrize("shape,r", [((2, 512), 4), ((2, 1024), 0),
                                     ((2, 1024), 1025)])
def test_block_topk_rejects_bad_shapes(shape, r):
    with pytest.raises(ValueError):
        block_topk.block_topk_2d(torch.zeros(shape), r=r)
