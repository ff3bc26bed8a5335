"""The port's Mamba2/SSD block (mamba2-780m) and the hybrid with shared
attention (zamba2-2.7b) on the CPU, against the JAX reference's.

Every test carries the reference's parameters across with
``convert.params_from_numpy``; inputs and tokens come from numpy seeds;
compute is float32 unless a test says otherwise.

* ``_causal_conv`` at bf16 to one bf16 rounding of its float32 result
  (rtol 2**-8), and bit for bit against its own tap-order sum;
* ``_segsum`` to rtol 1e-4 (its cumulative sums' rounding), with the
  upper triangle masked before the exp (no inf, finite gradients where
  the unmasked exp overflows);
* ``ssd_chunked`` against the reference's and against the sequential
  recurrence (atol 1e-4), with a chunk that does not divide S;
* ``mamba_forward`` and its cache (S >= and < d_conv - 1) and
  ``mamba_decode`` over 4 steps, in place, to atol 1e-5;
* the reduced mamba2-780m and zamba2-2.7b end to end: ``loss_fn`` and its
  gradients (rtol 1e-5 loss, rtol 1e-4 / atol 1e-6 every leaf, the shared
  block's summed over its uses), prefill then 4 decode steps continuing
  the port's own ``forward`` (atol 1e-4), and one DGS train step on four
  lanes under the train test's support-swap rule.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro.models import ssm as jssm
from repro_torch.convert import params_from_numpy
from repro_torch.core.paramspace import tree_flatten
from repro_torch.models import (decode_step, forward, init_caches,
                                init_params, loss_fn, prefill)
from repro_torch.models import ssm as tssm
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.config import SSMConfig as TSSM
from test_torch_train import _reference_runs, _steps_match_reference

MAMBA, ZAMBA = "mamba2-780m", "zamba2-2.7b"


def _cfgs(arch, **kw):
    """(reference, port) configs: the reduced ``arch`` in float32."""
    jc = dataclasses.replace(JARCHS[arch].reduced(), compute_dtype="float32",
                             **kw)
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    fields["ssm"] = TSSM(**dataclasses.asdict(jc.ssm))
    return jc, TConfig(**fields)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cache_leaves(tree, name=""):
    """[(name, leaf)] of a cache tree (dicts and cache named tuples)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree)
                for x in _cache_leaves(tree[key], f"{name}.{key}")]
    if isinstance(tree, tuple):
        return [x for field, leaf in zip(tree._fields, tree)
                for x in _cache_leaves(leaf, f"{name}.{field}")]
    return [(name, tree)]


def _block(jc, seed=3):
    """A Mamba2 block's parameters with nonzero conv and dt biases and
    D != 1, so each is exercised."""
    jp = jssm.mamba_init(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    jp = dict(jax.device_get(jp))
    for name in ("conv_b", "dt_bias", "D"):
        jp[name] = (jp[name] + 0.1 * rng.normal(size=jp[name].shape)) \
            .astype(np.float32)
    return jax.tree.map(jnp.asarray, jp), params_from_numpy(jp, "cpu")


def test_causal_conv_bf16():
    """The taps are multiplied and added in bf16 in tap order, the silu
    after a float32 bias add."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 40)).astype(np.float32)
    w = (rng.normal(size=(4, 40)) * 0.5).astype(np.float32)
    b = (rng.normal(size=40) * 0.1).astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                             jnp.asarray(b))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = tssm._causal_conv(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # one bf16 rounding of the pre-activation apart at most
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -8,
                               atol=2 ** -8)
    # the port's own: rounded after every product and add
    tw = torch.from_numpy(w).to(torch.bfloat16)
    pad = torch.nn.functional.pad(tx, (0, 0, 3, 0))
    acc = pad[:, 0:12] * tw[0]
    for i in range(1, 4):
        acc = (acc + (pad[:, i:i + 12] * tw[i]))
    assert acc.dtype == torch.bfloat16
    assert torch.equal(got, torch.nn.functional.silu(
        acc.float() + torch.from_numpy(b)))


def test_segsum_masks_before_exp():
    rng = np.random.default_rng(1)
    dA = -np.abs(rng.normal(size=(2, 3, 8)) * 60).astype(np.float32)
    want = jssm._segsum(jnp.asarray(dA))
    t = torch.from_numpy(dA).requires_grad_()
    got = tssm._segsum(t)
    # the cumulative sums run to about -300: a float32 ulp there is 3e-5
    # relative in the exp of their difference
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-30)
    assert torch.isfinite(got).all()
    assert not got.detach().triu(1).any()
    (g,) = torch.autograd.grad(got.sum(), t)
    assert torch.isfinite(g).all()


def _ssd_inputs(B=2, S=16, H=4, P=4, G=2, N=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = -np.exp(rng.normal(size=H)).astype(np.float32)
    Bm = rng.normal(size=(B, S, G, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _sequential(x, dt, A, Bm, Cm):
    """The recurrence one step at a time (float64)."""
    B, S, H, P = x.shape
    hpg = H // Bm.shape[2]
    s = np.zeros((B, H, P, Bm.shape[3]))
    ys = np.zeros((B, S, H, P))
    for t in range(S):
        decay = np.exp(dt[:, t] * A[None])
        xdt = x[:, t] * dt[:, t][..., None]
        Bt = np.repeat(Bm[:, t], hpg, axis=1)
        Ct = np.repeat(Cm[:, t], hpg, axis=1)
        s = s * decay[..., None, None] + xdt[..., None] * Bt[:, :, None, :]
        ys[:, t] = np.einsum("bhpn,bhn->bhp", s, Ct)
    return ys, s


@pytest.mark.parametrize("S,chunk", [(16, 4), (14, 4), (16, 16)],
                         ids=["chunks_of_4", "chunks_of_2", "one_chunk"])
def test_ssd_chunked_equals_reference_and_recurrence(S, chunk):
    """S = 14 with chunk 4 runs chunks of 2 (the largest divisor of S that
    is at most 4)."""
    args = _ssd_inputs(S=S)
    y, final = tssm.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk)
    jy, jfinal = jssm.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(final), _np(jfinal), rtol=1e-5, atol=1e-5)
    ys, s = _sequential(*(a.astype(np.float64) for a in args))
    np.testing.assert_allclose(_np(y), ys, atol=1e-4)
    np.testing.assert_allclose(_np(final), s, atol=1e-4)


@pytest.mark.parametrize("S", [16, 2], ids=["long", "shorter_than_conv"])
def test_mamba_forward_and_state_equal_reference(S):
    jc, tc = _cfgs(MAMBA)
    jp, tp = _block(jc)
    x = np.random.default_rng(2).normal(size=(2, S, jc.d_model)) \
        .astype(np.float32)
    want, jcache = jssm.mamba_forward(jp, jnp.asarray(x), jc,
                                      return_state=True)
    got, tcache = tssm.mamba_forward(tp, torch.from_numpy(x), tc,
                                     return_state=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    assert isinstance(tcache, tssm.SSMCache)
    assert tcache.state.dtype == torch.float32
    for field in ("state", "conv"):
        a, b = getattr(tcache, field), getattr(jcache, field)
        assert tuple(a.shape) == tuple(b.shape), field
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5,
                                   err_msg=field)
    if S < jc.ssm.d_conv - 1:
        assert not tcache.conv[:, :jc.ssm.d_conv - 1 - S].any()


def test_mamba_decode_equals_reference():
    """A prefill of 12, then 4 recurrent steps; the port writes its state
    and window in place."""
    jc, tc = _cfgs(MAMBA)
    jp, tp = _block(jc)
    x = np.random.default_rng(3).normal(size=(2, 16, jc.d_model)) \
        .astype(np.float32)
    _, jcache = jssm.mamba_forward(jp, jnp.asarray(x[:, :12]), jc,
                                   return_state=True)
    full = tssm.mamba_forward(tp, torch.from_numpy(x), tc)
    tcache = tssm.SSMCache(*(torch.from_numpy(np.array(c))
                             for c in jcache))
    for t in range(12, 16):
        want, jcache = jssm.mamba_decode(jp, jcache,
                                         jnp.asarray(x[:, t:t + 1]), t, jc)
        got, out = tssm.mamba_decode(tp, tcache,
                                     torch.from_numpy(x[:, t:t + 1]), t, tc)
        assert out is tcache
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(_np(got[:, 0]), _np(full[:, t]),
                                   atol=1e-5, err_msg=f"forward, step {t}")
    for field in ("state", "conv"):
        np.testing.assert_allclose(_np(getattr(tcache, field)),
                                   _np(getattr(jcache, field)), atol=1e-5,
                                   err_msg=field)


def test_a_log_is_the_references():
    for arch in (MAMBA, ZAMBA):
        jc, tc = _cfgs(arch)
        want = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jc))
        got = init_params(tc, seed=0, device="cpu")
        assert tree_flatten(got)[1] == tuple(
            tuple(p.key for p in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(want)[0])
        ref = np.asarray(jinit(jax.random.PRNGKey(0), jc)
                         ["units"]["b0"]["mamba"]["A_log"])
        np.testing.assert_allclose(
            got["units"]["b0"]["mamba"]["A_log"].numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_family_loss_and_grads_equal_reference(arch):
    jc, tc = _cfgs(arch)
    tokens = np.random.default_rng(2).integers(
        0, jc.vocab_size, (2, 32)).astype(np.int32)
    jp = jinit(jax.random.PRNGKey(0), jc)
    batch = {"tokens": jnp.asarray(tokens)}
    jl, jg = jax.value_and_grad(lambda p: jloss(p, batch, jc)[0])(jp)
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    leaves, paths = tree_flatten(tp)
    for leaf in leaves:
        leaf.requires_grad_()
    tl = loss_fn(tp, {"tokens": torch.from_numpy(tokens)}, tc)[0]
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jg = jax.tree.leaves(jg)
    assert len(tg) == len(jg)
    assert any(p[0] == "shared" for p in paths) == (arch == ZAMBA)
    for path, got, want in zip(paths, tg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_family_decode_continues_forward(arch):
    jc, tc = _cfgs(arch)
    tp = params_from_numpy(jax.device_get(jinit(jax.random.PRNGKey(0), jc)),
                           "cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, jc.vocab_size, (2, 32)).astype(np.int32))
    lf = forward(tp, tokens, tc)
    logits, caches, _ = prefill(tp, tokens[:, :28], tc, max_len=32)
    np.testing.assert_allclose(_np(logits[:, 0]), _np(lf[:, 27]), atol=1e-4)
    zero = init_caches(tc, 2, 32, device="cpu")
    got, want = _cache_leaves(caches), _cache_leaves(zero)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
    for t in range(28, 32):
        ld, caches = decode_step(tp, caches, tokens[:, t:t + 1], t, tc)
        np.testing.assert_allclose(_np(ld[:, 0]), _np(lf[:, t]), atol=1e-4,
                                   err_msg=f"step {t}")


def test_mamba2_adds_no_positions():
    """mamba2 has ``rope='none'`` but, as an SSM, no sinusoidal positions:
    a sequence and the same tokens shifted by one position give the same
    last logits when the SSM sees the same inputs."""
    jc, tc = _cfgs(MAMBA)
    tp = init_params(tc, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, jc.vocab_size, (1, 8)).astype(np.int32))
    _, caches, _ = prefill(tp, tokens[:, :1], tc)
    a, _ = decode_step(tp, caches, tokens[:, 1:2], 1, tc)
    _, caches, _ = prefill(tp, tokens[:, :1], tc)
    b, _ = decode_step(tp, caches, tokens[:, 1:2], 5, tc)
    assert torch.equal(a, b)


@pytest.fixture(scope="module")
def train_refs(tmp_path_factory):
    return _reference_runs(tmp_path_factory, [MAMBA, ZAMBA], steps=1)


@pytest.fixture(scope="module", params=[MAMBA, ZAMBA])
def train_ref(request, train_refs):
    return request.param, train_refs[request.param]


def test_family_train_step_matches_reference(train_ref):
    """One allgather step (exact engine, density 0.05) on four lanes
    against the reference's on four host devices, under the train test's
    support-swap rule; the SSM leaves, and the hybrid's unstacked shared
    block, are in the comparison."""
    arch, ref = train_ref
    paths, _ = _steps_match_reference(ref, arch, steps=1)
    assert ("units", "b0", "mamba", "A_log") in paths
    if arch == ZAMBA:
        assert ("shared", "attn", "wq", "w") in paths
