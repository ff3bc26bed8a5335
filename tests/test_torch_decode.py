"""The port's prefill and KV-cache decode on the CPU, against the JAX
reference's.

Every model test carries the reference's ``init_params`` across with
``convert.params_from_numpy``; tokens come from numpy seeds.  The families
are the reference's ``tests/test_models.py`` FAMILIES that the port runs
(dense, dense_bias, partial_rotary, sliding, local_global, tied; float32
compute):

* ``prefill`` logits and every cache leaf to rtol 1e-5 / atol 1e-5;
  ``decode_step`` logits over 4 steps to atol 1e-4;
* the port's own prefill + decode against its own ``forward``;
* a windowed layer past one full turn of its ring, and a prompt shorter
  than the window through ``_pad_caches``;
* decode ``input_specs`` / ``concrete_inputs`` for decode_32k and
  long_500k, ``cache_specs`` / ``batch_specs`` at model size 1 and 2;
* the bf16 config's greedy tokens, equal wherever the reference's top-2
  margin exceeds 5e-2 (the first disagreement ends the comparison);
* the MoE families (the reference's moe_dense and moe_capacity, and a
  capacity factor of 0.5 that drops pairs at prefill and at decode, where
  C comes from the step's B tokens) through all of the above, their
  prefill's aux losses to rtol 1e-5;
* the MLA, SSM and hybrid families (the reference's mla, ssm and
  hybrid_shared) through all of the above, their caches ``MLACache``,
  ``{"ssm": SSMCache}`` and ``"shared": KVCache``;
* the modality families (qwen2-vl-7b, musicgen-large): a prefill with
  their frontend embeddings and decode steps past it, to the same
  tolerances;
* what raises: a position past a linear cache.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as JARCHS
from repro.configs import shapes as jshapes
from repro.launch import sharding as jsharding
from repro.models import MLAConfig as JMLA
from repro.models import ModelConfig as JConfig
from repro.models import MoEConfig as JMoE
from repro.models import SSMConfig as JSSM
from repro.models import decode_step as jdecode
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import shapes as tshapes
from repro_torch.convert import params_from_numpy
from repro_torch.launch import sharding as tsharding
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import LaneMesh
from repro_torch.models import (decode_step, forward, init_caches,
                                init_params, prefill)
from repro_torch.models.config import MLAConfig as TMLA
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.config import MoEConfig as TMoE
from repro_torch.models.config import SSMConfig as TSSM

BASE = JConfig(name="t", arch_type="dense", n_layers=2, d_model=128,
               n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=256,
               head_dim=32, compute_dtype="float32")

# the reference's tests/test_models.py FAMILIES that the port runs
FAMILIES = {
    "dense": BASE,
    "dense_bias": dataclasses.replace(BASE, qkv_bias=True),
    "partial_rotary": dataclasses.replace(BASE, rotary_pct=0.5),
    "sliding": dataclasses.replace(BASE, attention="sliding", window=8),
    "local_global": dataclasses.replace(
        BASE, attention="local_global", local_global_ratio=1, window=8,
        rope_theta_local=10000.0),
    "tied": dataclasses.replace(BASE, tie_embeddings=True),
    "moe_dense": dataclasses.replace(
        BASE, arch_type="moe",
        moe=JMoE(n_experts=4, top_k=2, d_expert=128, impl="dense")),
    "moe_capacity": dataclasses.replace(
        BASE, arch_type="moe",
        moe=JMoE(n_experts=4, top_k=2, d_expert=128, impl="capacity",
                 capacity_factor=4.0)),
    "mla": dataclasses.replace(
        BASE, attention="mla",
        mla=JMLA(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                 qk_rope_head_dim=16, v_head_dim=32)),
    "ssm": dataclasses.replace(
        BASE, arch_type="ssm", attention="none", rope="none", d_ff=0,
        ssm=JSSM(d_state=16, head_dim=32, chunk=8)),
    "hybrid_shared": dataclasses.replace(
        BASE, arch_type="hybrid", attn_every=2, shared_attention=True,
        ssm=JSSM(d_state=16, head_dim=32, chunk=8)),
}
# held to the reference alone: its drops make decode differ from forward
# (C = 1 at a decode step of B = 2, 6 at a prefill of 2 x 24)
DROPS = {"moe_capacity_drops": dataclasses.replace(
    BASE, arch_type="moe",
    moe=JMoE(n_experts=4, top_k=2, d_expert=128, impl="capacity",
             capacity_factor=0.5))}
NAMES = sorted(JARCHS)
# every architecture's caches and input specs are made, and every one
# runs prefill and decode
PORTED = NAMES
DECODE_SHAPES = ("decode_32k", "long_500k")


def _tcfg(jc):
    """The port's ModelConfig with the reference config's fields."""
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    for name, cls in (("moe", TMoE), ("mla", TMLA), ("ssm", TSSM)):
        if fields[name] is not None:
            fields[name] = cls(**dataclasses.asdict(fields[name]))
    return TConfig(**fields)


@functools.cache
def _models(jc):
    """(reference params, port params) from the reference's seed-0
    ``init_params``, made once per config for the file (no test writes
    params; ``decode_step`` writes only the caches)."""
    jp = jinit(jax.random.PRNGKey(0), jc)
    return jp, params_from_numpy(jax.device_get(jp), "cpu")


def _tokens(jc, B=2, S=32, seed=1):
    return np.random.default_rng(seed).integers(
        0, jc.vocab_size, (B, S)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cache_leaves(caches, name=""):
    """[(name, leaf)] of a cache tree (dicts and cache named tuples), in
    JAX's leaf order."""
    if isinstance(caches, dict):
        return [x for key in sorted(caches)
                for x in _cache_leaves(caches[key], f"{name}.{key}")]
    if isinstance(caches, tuple):
        return [x for field, leaf in zip(caches._fields, caches)
                for x in _cache_leaves(leaf, f"{name}.{field}")]
    return [(name, caches)]


def _close_caches(got, want, rtol, atol):
    g, w = _cache_leaves(got), _cache_leaves(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape), name
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), name
        np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol,
                                   err_msg=name)


@functools.cache
def _jit_decode(jc):
    return jax.jit(lambda p, c, t, pos: jdecode(p, c, t, pos, jc))


@pytest.mark.parametrize("family", sorted(FAMILIES) + sorted(DROPS))
def test_prefill_logits_and_caches_equal_reference(family):
    jc = {**FAMILIES, **DROPS}[family]
    jp, tp = _models(jc)
    tokens = _tokens(jc)[:, :24]
    jl, jcaches, jaux = jprefill(jp, jnp.asarray(tokens), jc, max_len=32)
    tl, tcaches, aux = prefill(tp, torch.from_numpy(tokens), _tcfg(jc),
                               max_len=32)
    assert tl.shape == (2, 1, jc.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5, atol=1e-5)
    _close_caches(tcaches, jcaches, rtol=1e-5, atol=1e-5)
    assert set(aux) == set(jaux) == {"load_balance", "router_z"}
    for key in aux:
        np.testing.assert_allclose(_np(aux[key]), _np(jaux[key]), rtol=1e-5,
                                   err_msg=key)
    if jc.moe is None:
        assert not any(bool(v) for v in aux.values())


@pytest.mark.parametrize("family", sorted(FAMILIES) + sorted(DROPS))
def test_decode_steps_equal_reference(family):
    jc = {**FAMILIES, **DROPS}[family]
    jp, tp = _models(jc)
    tokens = _tokens(jc)
    _, jcaches, _ = jprefill(jp, jnp.asarray(tokens[:, :28]), jc, max_len=32)
    _, tcaches, _ = prefill(tp, torch.from_numpy(tokens[:, :28]), _tcfg(jc),
                            max_len=32)
    step = _jit_decode(jc)
    for t in range(28, 32):
        jl, jcaches = step(jp, jcaches, jnp.asarray(tokens[:, t:t + 1]),
                           jnp.int32(t))
        tl, tcaches = decode_step(tp, tcaches,
                                  torch.from_numpy(tokens[:, t:t + 1]), t,
                                  _tcfg(jc))
        np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4,
                                   err_msg=f"step {t}")
    _close_caches(tcaches, jcaches, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decode_continuation_matches_forward(family):
    """As the reference's ``tests/test_models.py``: the last token decoded
    after a prefill of the rest gives the forward's last logits, and 4
    steps after a prefill of 28 track the forward."""
    tc = _tcfg(FAMILIES[family])
    _, tp = _models(FAMILIES[family])
    tokens = torch.from_numpy(_tokens(tc))
    lf = forward(tp, tokens, tc)
    _, caches, _ = prefill(tp, tokens[:, :-1], tc, max_len=32)
    ld, _ = decode_step(tp, caches, tokens[:, -1:], 31, tc)
    np.testing.assert_allclose(_np(ld[:, 0]), _np(lf[:, -1]), atol=1e-4)
    _, caches, _ = prefill(tp, tokens[:, :28], tc, max_len=32)
    for t in range(28, 32):
        ld, caches = decode_step(tp, caches, tokens[:, t:t + 1], t, tc)
        np.testing.assert_allclose(_np(ld[:, 0]), _np(lf[:, t]), atol=1e-4,
                                   err_msg=f"step {t}")


@pytest.mark.parametrize("prompt,max_len", [(13, 32), (5, 20)],
                         ids=["ring_past_a_turn", "short_prompt_padded"])
@pytest.mark.parametrize("family", ["sliding", "local_global"])
def test_windowed_cache_against_forward_and_reference(family, prompt,
                                                      max_len):
    """Window 8.  A prompt of 13 leaves a ring of 8 slots rolled by 5; 12
    decode steps (positions 13-24) wrap it one and a half times.  A prompt
    of 5 leaves a linear cache that ``_pad_caches`` pads to ``max_len``
    and decode treats as windowed; positions 8 on drop the oldest."""
    jc = FAMILIES[family]
    tc = _tcfg(jc)
    jp, tp = _models(jc)
    n = min(max_len, prompt + 12)
    tokens = _tokens(jc, S=n, seed=7)
    lf = forward(tp, torch.from_numpy(tokens), tc)
    _, jcaches, _ = jprefill(jp, jnp.asarray(tokens[:, :prompt]), jc,
                             max_len=max_len)
    _, tcaches, _ = prefill(tp, torch.from_numpy(tokens[:, :prompt]), tc,
                            max_len=max_len)
    windowed = {"sliding": ["b0"], "local_global": ["b0"]}[family]
    for key, c in tcaches.items():
        want = min(8, prompt) if key in windowed and prompt > 8 else max_len
        assert c.k.shape[2] == want, (key, c.k.shape)
    _close_caches(tcaches, jcaches, rtol=1e-5, atol=1e-5)
    step = _jit_decode(jc)
    for t in range(prompt, n):
        tok = tokens[:, t:t + 1]
        jl, jcaches = step(jp, jcaches, jnp.asarray(tok), jnp.int32(t))
        tl, tcaches = decode_step(tp, tcaches, torch.from_numpy(tok), t, tc)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4,
                                   err_msg=f"reference, step {t}")
        np.testing.assert_allclose(_np(tl[:, 0]), _np(lf[:, t]), atol=1e-4,
                                   err_msg=f"forward, step {t}")
    _close_caches(tcaches, jcaches, rtol=1e-5, atol=1e-5)


def _spec_leaves(specs):
    """(shape, dtype name) of every leaf of an ``input_specs`` tree, in
    JAX's leaf order, for either package."""
    if isinstance(specs, dict):
        return [x for key in sorted(specs) for x in _spec_leaves(specs[key])]
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return [x for leaf in specs for x in _spec_leaves(leaf)]
    if isinstance(specs, tuple):                    # the port's pair
        return [(tuple(specs[0]), str(specs[1]).removeprefix("torch."))]
    if isinstance(specs, int):                      # the port's pos
        return [((), "int32")]
    return [(tuple(specs.shape), str(specs.dtype).removeprefix("torch."))]


@pytest.mark.parametrize("shape_name", DECODE_SHAPES)
@pytest.mark.parametrize("name", PORTED)
def test_decode_input_specs_and_concrete_inputs(name, shape_name):
    jshape = jshapes.SHAPES[shape_name]
    tshape = tshapes.SHAPES[shape_name]
    want = jshapes.input_specs(JARCHS[name], jshape)
    got = tshapes.input_specs(TARCHS[name], tshape)
    assert sorted(got) == sorted(want)
    for key in want:
        assert _spec_leaves(got[key]) == _spec_leaves(want[key]), key
    # concrete inputs at the reduced config and a cut shape (long stays
    # past the reduced window of 64, so its windowed caches are rings)
    cut = dict(decode_32k=(96, 2), long_500k=(160, 1))[shape_name]
    jcut = dataclasses.replace(jshape, seq_len=cut[0], global_batch=cut[1])
    tcut = dataclasses.replace(tshape, seq_len=cut[0], global_batch=cut[1])
    jc, tc = JARCHS[name].reduced(), TARCHS[name].reduced()
    want = jshapes.concrete_inputs(jc, jcut)
    got = tshapes.concrete_inputs(tc, tcut, seed=3, device="cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert _spec_leaves(got[key]) == _spec_leaves(want[key]), key
    assert got["pos"] == int(want["pos"]) == cut[0] // 2
    assert all(not leaf.any() for _, leaf in _cache_leaves(got["caches"]))
    tok = got["token"]
    assert int(tok.min()) >= 0 and int(tok.max()) < tc.vocab_size
    again = tshapes.concrete_inputs(tc, tcut, seed=3, device="cpu")
    assert torch.equal(again["token"], tok)


def _port_spec_leaves(tree):
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _port_spec_leaves(
            tree[key])]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for leaf in tree for x in _port_spec_leaves(leaf)]
    return [tree]


def _ref_spec_leaves(tree):
    return [tuple(p) for p in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


@pytest.mark.parametrize("model_size", [1, 2])
@pytest.mark.parametrize("name", PORTED)
def test_cache_and_batch_specs_equal_reference(name, model_size):
    jc, tc = JARCHS[name], TARCHS[name]
    for shape_name in DECODE_SHAPES:
        jspecs = jshapes.input_specs(jc, jshapes.SHAPES[shape_name])
        tspecs = tshapes.input_specs(tc, tshapes.SHAPES[shape_name])
        B = jshapes.SHAPES[shape_name].global_batch
        for data_axes in (("data",), ("pod", "data")):
            for n_data in (1, 4, 256):
                want = jsharding.cache_specs(jc, jspecs["caches"], data_axes,
                                             model_size, batch=B,
                                             n_data=n_data)
                got = tsharding.cache_specs(tc, tspecs["caches"], data_axes,
                                            model_size, batch=B,
                                            n_data=n_data)
                assert _port_spec_leaves(got) == _ref_spec_leaves(want), \
                    (shape_name, data_axes, n_data)
            inputs = {k: v for k, v in jspecs.items() if k != "caches"}
            want = jsharding.batch_specs(jc, inputs, data_axes)
            got = tsharding.batch_specs(
                tc, {k: v for k, v in tspecs.items() if k != "caches"},
                data_axes)
            assert _port_spec_leaves(got) == _ref_spec_leaves(want)
    train = tshapes.input_specs(tc, tshapes.SHAPES["train_4k"])
    want = jsharding.batch_specs(
        jc, jshapes.input_specs(jc, jshapes.SHAPES["train_4k"]), ("data",))
    assert _port_spec_leaves(tsharding.batch_specs(tc, train, ("data",))) \
        == _ref_spec_leaves(want)


def test_build_step_dispatches_on_the_shape_kind():
    tc = TARCHS["gemma3-12b"].reduced()
    mesh = LaneMesh(4, "cpu")
    shapes = tshapes.SHAPES
    assert isinstance(tsteps.build_step(tc, mesh, shapes["train_4k"]),
                      tsteps.TrainStep)
    pre = tsteps.build_step(tc, mesh, shapes["prefill_32k"])
    assert isinstance(pre, tsteps.PrefillStep)
    assert pre.batch_specs == {"tokens": ("data", None)}
    serve = tsteps.build_step(tc, mesh, shapes["long_500k"])
    assert isinstance(serve, tsteps.ServeStep) and serve.long_mode
    # B = 1 does not split over 4 workers: the cache length does
    assert serve.cache_specs["b0"].k == (None, None, "data", None, "model")
    # the steps compute what prefill and decode_step do
    tc = dataclasses.replace(tc, compute_dtype="float32")
    params = init_params(tc, seed=0, device="cpu")
    tokens = torch.from_numpy(_tokens(tc, S=70, seed=4))
    pre = tsteps.build_prefill_step(tc, mesh,
                                    shape=dataclasses.replace(
                                        shapes["prefill_32k"], seq_len=69,
                                        global_batch=2))
    logits, caches = pre(params, {"tokens": tokens[:, :69]})
    want, _, _ = prefill(params, tokens[:, :69], tc)
    assert torch.equal(logits, want)
    # the prefill step pads no headroom (as the reference's)
    assert caches["b1"].k.shape[2] == 69
    _, caches, _ = prefill(params, tokens[:, :69], tc, max_len=70)
    serve = tsteps.build_serve_step(tc, mesh, shape=shapes["decode_32k"])
    assert not serve.long_mode
    got, _ = serve(params, caches, tokens[:, 69:], 69)
    np.testing.assert_allclose(_np(got[:, 0]),
                               _np(forward(params, tokens, tc)[:, -1]),
                               atol=1e-4)


def _margin(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.mark.parametrize("arch", ["chatglm3-6b", "gemma3-12b",
                                  "minicpm3-4b", "mamba2-780m",
                                  "zamba2-2.7b"])
def test_bf16_greedy_tokens_equal_reference(arch):
    """The bf16-compute reduced config, 8 greedy steps after a prompt of
    24: the tokens agree wherever the reference's top-2 margin exceeds
    5e-2; the first disagreement (within the margin) ends the
    comparison."""
    jc = JARCHS[arch].reduced()
    assert jc.compute_dtype == "bfloat16"
    tc = _tcfg(jc)
    jp, tp = _models(jc)
    prompt = _tokens(jc, S=24, seed=5)
    jl, jcaches, _ = jprefill(jp, jnp.asarray(prompt), jc, max_len=32)
    tl, tcaches, _ = prefill(tp, torch.from_numpy(prompt), tc, max_len=32)
    step = _jit_decode(jc)
    compared = 0
    for t in range(24, 32):
        jlog, tlog = _np(jl[:, -1]), _np(tl[:, -1])
        jt, tt = jlog.argmax(-1), tlog.argmax(-1)
        differ = jt != tt
        if differ.any():
            assert (_margin(jlog)[differ] <= 5e-2).all(), \
                (t, _margin(jlog)[differ])
            break
        compared += 1
        jl, jcaches = step(jp, jcaches, jnp.asarray(jt[:, None], jnp.int32),
                           jnp.int32(t))
        tl, tcaches = decode_step(
            tp, tcaches, torch.from_numpy(tt[:, None].astype(np.int32)), t,
            tc)
    assert compared >= 1


def test_pos_past_a_linear_cache_raises():
    """Where the reference's update slice clamps the position to the last
    slot, the port raises; a ring takes any position."""
    jc = FAMILIES["local_global"]
    tc = _tcfg(jc)
    _, tp = _models(jc)
    tokens = torch.from_numpy(_tokens(jc, S=10))
    _, caches, _ = prefill(tp, tokens[:, :8], tc, max_len=10)
    for pos in (10, 11, -1):
        with pytest.raises(IndexError, match="linear cache"):
            decode_step(tp, caches, tokens[:, :1], pos, tc)
    _, caches, _ = prefill(tp, tokens[:, :8], tc)
    with pytest.raises(IndexError, match="linear cache"):
        decode_step(tp, caches, tokens[:, :1], 8, tc)
    sliding = _tcfg(FAMILIES["sliding"])
    ring = init_caches(sliding, 2, 32, device="cpu")
    assert ring["b0"].k.shape == (2, 2, 8, 2, 32)
    logits, _ = decode_step(_models(FAMILIES["sliding"])[1], ring,
                            tokens[:, :1], 1000, sliding)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("name", ["musicgen-large", "qwen2-vl-7b"])
def test_other_families_raise_in_caches_and_decode(name):
    """The modality families: caches and decode specs are made, and a
    prefill of 24 positions with the frontend's 16 embeddings, then 6
    decode steps past it, give the reference's logits (rtol/atol 1e-5 at
    prefill, atol 1e-4 a step) and caches (rtol/atol 1e-5), float32."""
    jc = dataclasses.replace(JARCHS[name].reduced(), compute_dtype="float32")
    tc = _tcfg(jc)
    assert init_caches(tc, 2, 16, device="cpu")
    assert tshapes.input_specs(tc, tshapes.SHAPES["decode_32k"])["caches"]
    jp, tp = _models(jc)
    tokens = _tokens(jc, S=30, seed=8)
    fe = np.random.default_rng(8).normal(
        size=(2, jc.frontend_tokens, jc.d_model)).astype(np.float32)
    jl, jcaches, _ = jprefill(jp, jnp.asarray(tokens[:, :24]), jc,
                              frontend_embeds=jnp.asarray(fe), max_len=30)
    tl, tcaches, _ = prefill(tp, torch.from_numpy(tokens[:, :24]), tc,
                             frontend_embeds=torch.from_numpy(fe),
                             max_len=30)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5, atol=1e-5)
    _close_caches(tcaches, jcaches, rtol=1e-5, atol=1e-5)
    step = _jit_decode(jc)
    for t in range(24, 30):
        jl, jcaches = step(jp, jcaches, jnp.asarray(tokens[:, t:t + 1]),
                           jnp.int32(t))
        tl, tcaches = decode_step(tp, tcaches,
                                  torch.from_numpy(tokens[:, t:t + 1]), t, tc)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4,
                                   err_msg=f"step {t}")
    _close_caches(tcaches, jcaches, rtol=1e-5, atol=1e-5)
