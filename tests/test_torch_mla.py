"""The port's MLA (multi-head latent attention, minicpm3-4b) on the CPU,
against the JAX reference's.

Every test carries the reference's parameters across with
``convert.params_from_numpy``; inputs and tokens come from numpy seeds;
compute is float32 unless a test says otherwise.

* ``mla_forward`` (query chunks of 8 and one chunk) and its cache to rtol
  1e-5 / atol 1e-5;
* ``mla_decode`` in both branches (``absorb=False``, minicpm3's, and
  ``absorb=True``) over 4 steps after a cache of 12: outputs to atol
  1e-5, the cache written in place to the reference's to atol 1e-5;
* ``mla_init_cache`` is linear over ``seq_len`` in long mode too;
* the reduced minicpm3-4b end to end: ``loss_fn`` and its gradients
  (rtol 1e-5 loss, rtol 1e-4 / atol 1e-6 every leaf), prefill then 4
  decode steps continuing the port's own ``forward`` (atol 1e-4) in both
  branches, and one DGS train step on four lanes under the train test's
  support-swap rule.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import attention as jattn
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro_torch.convert import params_from_numpy
from repro_torch.core.paramspace import tree_flatten
from repro_torch.models import attention as tattn
from repro_torch.models import (decode_step, forward, init_caches, loss_fn,
                                prefill)
from repro_torch.models.config import MLAConfig as TMLA
from repro_torch.models.config import ModelConfig as TConfig
from test_torch_train import _reference_runs, _steps_match_reference

ARCH = "minicpm3-4b"


def _cfgs(absorb=False, **kw):
    """(reference, port) configs: the reduced minicpm3-4b in float32."""
    jc = dataclasses.replace(JARCHS[ARCH].reduced(), compute_dtype="float32",
                             **kw)
    jc = dataclasses.replace(jc, mla=dataclasses.replace(jc.mla,
                                                         absorb=absorb))
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    fields["mla"] = TMLA(**dataclasses.asdict(jc.mla))
    return jc, TConfig(**fields)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _layer(jc, seed=3):
    jp = jattn.mla_init(jax.random.PRNGKey(seed), jc)
    return jp, params_from_numpy(jax.device_get(jp), "cpu")


def _x(jc, B=2, S=16, seed=1):
    x = np.random.default_rng(seed).normal(size=(B, S, jc.d_model))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return x.astype(np.float32), pos


@pytest.mark.parametrize("chunk_q", [8, 512])
def test_mla_forward_and_cache_equal_reference(chunk_q):
    jc, tc = _cfgs()
    jp, tp = _layer(jc)
    x, pos = _x(jc)
    want, jcache = jattn.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos),
                                     jc, chunk_q=chunk_q, return_kv=True)
    got, tcache = tattn.mla_forward(tp, torch.from_numpy(x),
                                    torch.from_numpy(pos), tc,
                                    chunk_q=chunk_q, return_kv=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    assert isinstance(tcache, tattn.MLACache)
    for field in ("c_kv", "k_rope"):
        a, b = getattr(tcache, field), getattr(jcache, field)
        assert tuple(a.shape) == tuple(b.shape), field
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5,
                                   err_msg=field)
    # without the cache: the same output
    again = tattn.mla_forward(tp, torch.from_numpy(x), torch.from_numpy(pos),
                              tc, chunk_q=chunk_q)
    assert torch.equal(again, got)


@pytest.mark.parametrize("absorb", [False, True],
                         ids=["expand", "absorb"])
def test_mla_decode_equals_reference(absorb):
    """A cache of 12 positions padded to 16, then 4 decode steps; the
    port writes its cache in place."""
    jc, tc = _cfgs(absorb=absorb)
    jp, tp = _layer(jc)
    x, pos = _x(jc, S=16, seed=2)
    _, jcache = jattn.mla_forward(jp, jnp.asarray(x[:, :12]),
                                  jnp.asarray(pos[:, :12]), jc,
                                  return_kv=True)
    jcache = jattn.MLACache(*(jnp.pad(c, ((0, 0), (0, 4), (0, 0)))
                              for c in jcache))
    tcache = tattn.MLACache(*(torch.from_numpy(np.array(c))
                              for c in jcache))
    for t in range(12, 16):
        want, jcache = jattn.mla_decode(jp, jcache, jnp.asarray(x[:, t:t + 1]),
                                        jnp.int32(t), jc)
        got, out_cache = tattn.mla_decode(tp, tcache,
                                          torch.from_numpy(x[:, t:t + 1]), t,
                                          tc)
        assert out_cache is tcache
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5,
                                   err_msg=f"step {t}")
    for field in ("c_kv", "k_rope"):
        np.testing.assert_allclose(_np(getattr(tcache, field)),
                                   _np(getattr(jcache, field)), atol=1e-5,
                                   err_msg=field)
    with pytest.raises(IndexError, match="linear cache"):
        tattn.mla_decode(tp, tcache, torch.from_numpy(x[:, :1]), 16, tc)


def test_mla_branches_agree():
    """``absorb=True`` folds ``wkv_b`` into the query and the output: the
    same function as expanding the cache, to float32 rounding."""
    jc, tc = _cfgs()
    _, tc_abs = _cfgs(absorb=True)
    _, tp = _layer(jc)
    x, pos = _x(jc, S=10, seed=4)
    _, cache = tattn.mla_forward(tp, torch.from_numpy(x[:, :9]),
                                 torch.from_numpy(pos[:, :9]), tc,
                                 return_kv=True)
    cache = tattn.MLACache(*(torch.nn.functional.pad(c, (0, 0, 0, 1))
                             for c in cache))
    copy = tattn.MLACache(*(c.clone() for c in cache))
    a, _ = tattn.mla_decode(tp, cache, torch.from_numpy(x[:, 9:]), 9, tc)
    b, _ = tattn.mla_decode(tp, copy, torch.from_numpy(x[:, 9:]), 9, tc_abs)
    np.testing.assert_allclose(_np(a), _np(b), atol=1e-5)
    full = tattn.mla_forward(tp, torch.from_numpy(x), torch.from_numpy(pos),
                             tc)
    np.testing.assert_allclose(_np(a[:, 0]), _np(full[:, -1]), atol=1e-5)


@pytest.mark.parametrize("long_mode", [False, True])
def test_mla_caches_are_linear(long_mode):
    """The reduced minicpm3 has ``long_context='sliding_window'`` and a
    window of 64; its latent cache keeps all 100 positions anyway."""
    jc, tc = _cfgs()
    want = jax.eval_shape(lambda: jinit_caches(jc, 2, 100,
                                               long_mode=long_mode))
    got = init_caches(tc, 2, 100, long_mode=long_mode, device="cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert isinstance(got[key], tattn.MLACache)
        for a, b in zip(got[key], want[key]):
            assert tuple(a.shape) == tuple(b.shape) and a.shape[2] == 100
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
            assert not a.any()


def test_minicpm3_loss_and_grads_equal_reference():
    jc, tc = _cfgs()
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
    assert any(p[-2:] == ("wkv_b", "w") for p in paths)
    for path, got, want in zip(paths, tg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("absorb", [False, True],
                         ids=["expand", "absorb"])
def test_minicpm3_decode_continues_forward(absorb):
    jc, tc = _cfgs(absorb=absorb)
    tp = params_from_numpy(jax.device_get(jinit(jax.random.PRNGKey(0), jc)),
                           "cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, jc.vocab_size, (2, 32)).astype(np.int32))
    lf = forward(tp, tokens, tc)
    logits, caches, _ = prefill(tp, tokens[:, :28], tc, max_len=32)
    np.testing.assert_allclose(_np(logits[:, 0]), _np(lf[:, 27]), atol=1e-4)
    assert caches["b0"].c_kv.shape == (2, 2, 32, jc.mla.kv_lora_rank)
    for t in range(28, 32):
        ld, caches = decode_step(tp, caches, tokens[:, t:t + 1], t, tc)
        np.testing.assert_allclose(_np(ld[:, 0]), _np(lf[:, t]), atol=1e-4,
                                   err_msg=f"step {t}")


@pytest.fixture(scope="module")
def train_ref(tmp_path_factory):
    return _reference_runs(tmp_path_factory, [ARCH], steps=1)[ARCH]


def test_minicpm3_train_step_matches_reference(train_ref):
    """One allgather step (exact engine, density 0.05) on four lanes
    against the reference's on four host devices, under the train test's
    support-swap rule; the MLA leaves are in the comparison."""
    paths, _ = _steps_match_reference(train_ref, ARCH, steps=1)
    assert ("units", "b0", "attn", "wkv_b", "w") in paths
