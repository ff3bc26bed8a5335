"""The port's M-RoPE and modality frontends (qwen2-vl-7b, musicgen-large)
on the CPU, against the JAX reference's.

Every model test carries the reference's ``init_params`` across with
``convert.params_from_numpy``; tokens and frontend embeddings come from
numpy seeds; compute is float32 unless a test says otherwise.

* ``rope.mrope`` at head_dim 128 (qwen2-vl's sections (16, 24, 24)) and
  64 (the reduced config's (8, 12, 12)), for three-stream and degenerate
  text positions, to rtol 1e-5 / atol 1e-6; ``gqa_forward`` and
  ``gqa_decode`` under M-RoPE at head_dim 64 (the sections follow the
  config) to rtol 1e-4 / atol 1e-5;
* ``mrope_positions``, ``mrope_text_position`` and ``merge_frontend`` bit
  for bit;
* the reduced qwen2-vl-7b and musicgen-large with their frontend
  embeddings: ``forward`` and ``loss_fn`` in float32 (logits rtol/atol
  1e-4, loss rtol 1e-4, every gradient leaf rtol 1e-4 / atol 1e-6) and in
  bf16 (loss rtol 2e-2, greedy tokens equal wherever the reference's
  top-2 margin exceeds 5e-2); ``prefill`` then decode steps past the
  frontend at the reduced forms of decode_32k (a linear cache) and
  long_500k (long mode: a ring of the 64-slot window, wrapped), logits to
  atol 1e-4 and caches to rtol/atol 1e-5, and against the port's own
  ``forward``;
* both packages refuse a sequence shorter than the frontend;
* prefill ``input_specs``, ``concrete_inputs`` and the prefill step carry
  the frontend embeddings;
* one DGS train step on four lanes under the train test's support-swap
  rule.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import attention as jattn
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro.models import multimodal as jmm
from repro.models import prefill as jprefill
from repro.models import rope as jrope
from repro_torch.convert import params_from_numpy
from repro_torch.core.paramspace import tree_flatten
from repro_torch.models import attention as tattn
from repro_torch.models import (decode_step, forward, loss_fn, multimodal,
                                prefill)
from repro_torch.models import rope as trope
from repro_torch.models.config import ModelConfig as TConfig
from test_torch_decode import _close_caches, _margin
from test_torch_train import _reference_runs, _steps_match_reference

VL, MUSIC = "qwen2-vl-7b", "musicgen-large"
ARCHS = (VL, MUSIC)


def _cfgs(arch, dtype="float32"):
    """(reference, port) configs: the reduced ``arch`` in ``dtype``
    compute (16 frontend positions)."""
    jc = dataclasses.replace(JARCHS[arch].reduced(), compute_dtype=dtype)
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    return jc, TConfig(**fields)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _models(jc):
    jp = jinit(jax.random.PRNGKey(0), jc)
    return jp, params_from_numpy(jax.device_get(jp), "cpu")


def _inputs(jc, B=2, S=40, seed=1):
    """Tokens (B, S) int32 and frontend embeddings (B, n, d) float32."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    fe = rng.normal(size=(B, jc.frontend_tokens, jc.d_model))
    return tokens, fe.astype(np.float32)


# ------------------------------------------------------------- M-RoPE --

def _grid_positions(rng, B, S):
    """Three distinct (t, h, w) streams: a patch grid's h and w over a
    constant t, then text."""
    base = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    pos = np.stack([base // 7, base % 11, base + rng.integers(0, 5, (B, S))])
    return pos.astype(np.int32)


@pytest.mark.parametrize("streams", ["grid", "text"])
@pytest.mark.parametrize("hd", [128, 64])
def test_mrope_equals_reference(hd, streams):
    rng = np.random.default_rng(hd)
    B, S, H = 2, 24, 3
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, 1, hd)).astype(np.float32)
    half = hd // 2
    t = half // 4
    sections = (t, (half - t) // 2, half - t - (half - t) // 2)
    if streams == "grid":
        pos = _grid_positions(rng, B, S) * 997
    else:
        pos = np.array(jrope.text_mrope_positions(jnp.asarray(
            np.broadcast_to(np.arange(S, dtype=np.int32) + 300, (B, S)))))
        got = trope.text_mrope_positions(torch.from_numpy(pos[0]))
        assert torch.equal(got, torch.from_numpy(pos))
    want = jrope.mrope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                       theta=1e6, sections=sections)
    got = trope.mrope(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(pos), theta=1e6, sections=sections)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    if streams == "text":
        # equal streams: M-RoPE is the standard rotation
        std = trope.standard_rope(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(pos[0]), theta=1e6)
        for a, b in zip(got, std):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


def test_mrope_leaves_the_dims_past_the_sections():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(1, 6, 2, 64)).astype(np.float32)
    pos = _grid_positions(rng, 1, 6)
    got, _ = trope.mrope(torch.from_numpy(q), torch.from_numpy(q),
                         torch.from_numpy(pos), theta=1e4,
                         sections=(4, 6, 6))
    want, _ = jrope.mrope(jnp.asarray(q), jnp.asarray(q), jnp.asarray(pos),
                          theta=1e4, sections=(4, 6, 6))
    assert torch.equal(got[..., 32:], torch.from_numpy(q[..., 32:]))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


def test_mrope_sections_follow_the_head_dim():
    """(16, 24, 24) at qwen2-vl's head_dim 128, (8, 12, 12) at the
    reduced 64; the default sections would need a rotary dim of 128."""
    for arch_cfg in (JARCHS[VL], JARCHS[VL].reduced()):
        fields = {f.name: getattr(arch_cfg, f.name)
                  for f in dataclasses.fields(arch_cfg)}
        assert tattn._mrope_sections(TConfig(**fields)) == \
            jattn._mrope_sections(arch_cfg)
    assert tattn._mrope_sections(TConfig(**{
        f.name: getattr(JARCHS[VL], f.name)
        for f in dataclasses.fields(JARCHS[VL])})) == (16, 24, 24)


def test_gqa_mrope_forward_and_decode_equal_reference():
    """The reduced qwen2-vl's attention layer (head_dim 64, sections (8,
    12, 12)): the forward over the grid's positions, and 4 decode steps
    past it, whose rotation takes the text position."""
    jc, tc = _cfgs(VL)
    jp = jattn.gqa_init(jax.random.PRNGKey(3), jc)
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 24, jc.d_model)).astype(np.float32)
    pos = np.array(jmm.mrope_positions(jc, 2, 24))
    want, jcache = jattn.gqa_forward(jp, jnp.asarray(x[:, :20]),
                                     jnp.asarray(pos[:, :, :20]), jc,
                                     return_kv=True)
    got, tcache = tattn.gqa_forward(tp, torch.from_numpy(x[:, :20]),
                                    torch.from_numpy(pos[:, :, :20]), tc,
                                    return_kv=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)
    jcache = jattn.KVCache(*(jnp.pad(c, ((0, 0), (0, 4), (0, 0), (0, 0)))
                             for c in jcache))
    tcache = tattn.KVCache(*(torch.from_numpy(np.array(c)) for c in jcache))
    full = tattn.gqa_forward(tp, torch.from_numpy(x),
                             torch.from_numpy(pos), tc)
    for t in range(20, 24):
        want, jcache = jattn.gqa_decode(jp, jcache,
                                        jnp.asarray(x[:, t:t + 1]),
                                        jnp.int32(t), jc)
        got, _ = tattn.gqa_decode(tp, tcache, torch.from_numpy(x[:, t:t + 1]),
                                  t, tc)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-5, err_msg=f"step {t}")
        np.testing.assert_allclose(_np(got[:, 0]), _np(full[:, t]),
                                   rtol=1e-4, atol=1e-5, err_msg=f"step {t}")


# ------------------------------------------------------- the frontends --

@pytest.mark.parametrize("n,S", [(16, 40), (1024, 1280), (0, 8), (10, 12),
                                 (9, 9)])
def test_mrope_positions_equal_reference(n, S):
    jc = dataclasses.replace(JARCHS[VL].reduced(), frontend_tokens=n)
    _, tc = _cfgs(VL)
    tc = dataclasses.replace(tc, frontend_tokens=n)
    want = np.asarray(jmm.mrope_positions(jc, 3, S))
    got = multimodal.mrope_positions(tc, 3, S, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    for pos in (n, n + 1, S + 7, 262_144):
        assert multimodal.mrope_text_position(tc, pos) == \
            int(jmm.mrope_text_position(jc, pos))
    if S > n:
        # decode continues the prompt's text positions
        assert multimodal.mrope_text_position(tc, S - 1) == \
            int(got[0, 0, -1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_frontend_bit_equal(dtype):
    jc, tc = _cfgs(MUSIC, dtype)
    rng = np.random.default_rng(5)
    h = rng.normal(size=(2, 20, jc.d_model)).astype(np.float32)
    fe = rng.normal(size=(2, jc.frontend_tokens, jc.d_model))
    fe = fe.astype(np.float32)
    want = jmm.merge_frontend(jc, jnp.asarray(h).astype(jc.cdtype),
                              jnp.asarray(fe))
    got = multimodal.merge_frontend(tc, torch.from_numpy(h).to(tc.cdtype),
                                    torch.from_numpy(fe))
    assert got.dtype == tc.cdtype
    np.testing.assert_array_equal(_np(got), _np(want))
    assert torch.equal(multimodal.merge_frontend(tc, torch.from_numpy(h),
                                                 None), torch.from_numpy(h))


@pytest.mark.parametrize("arch", ARCHS)
def test_a_sequence_shorter_than_the_frontend_is_refused(arch):
    """Both packages refuse S < frontend_tokens (16 in the reduced
    configs): the merged sequence would be 16 positions long."""
    jc, tc = _cfgs(arch)
    jp, tp = _models(jc)
    tokens, fe = _inputs(jc, S=jc.frontend_tokens - 1)
    with pytest.raises((TypeError, ValueError)):
        jforward(jp, jnp.asarray(tokens), jc, frontend_embeds=jnp.asarray(fe))
    with pytest.raises(ValueError, match="shorter than the frontend"):
        forward(tp, torch.from_numpy(tokens), tc,
                frontend_embeds=torch.from_numpy(fe))
    with pytest.raises(ValueError, match="shorter than the frontend"):
        prefill(tp, torch.from_numpy(tokens), tc,
                frontend_embeds=torch.from_numpy(fe))


# ------------------------------------------------- the models end to end --

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_float32_equal_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _models(jc)
    tokens, fe = _inputs(jc)
    jl, _ = jforward(jp, jnp.asarray(tokens), jc,
                     frontend_embeds=jnp.asarray(fe))
    tl = forward(tp, torch.from_numpy(tokens), tc,
                 frontend_embeds=torch.from_numpy(fe))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    # the embeddings reach the logits: without them the model differs
    plain = forward(tp, torch.from_numpy(tokens), tc)
    assert not torch.allclose(plain[:, -1], tl[:, -1], atol=1e-3)

    jbatch = {"tokens": jnp.asarray(tokens),
              "frontend_embeds": jnp.asarray(fe)}
    jloss_v, jgrads = jax.value_and_grad(
        lambda p: jloss(p, jbatch, jc)[0])(jp)
    leaves, paths = tree_flatten(tp)
    for leaf in leaves:
        leaf.requires_grad_()
    tloss_v, metrics = loss_fn(tp, {"tokens": torch.from_numpy(tokens),
                                    "frontend_embeds": torch.from_numpy(fe)},
                               tc)
    np.testing.assert_allclose(float(tloss_v.detach()), float(jloss_v),
                               rtol=1e-4)
    assert set(metrics) == {"nll", "load_balance", "router_z"}
    grads = torch.autograd.grad(tloss_v, leaves)
    jgrads = jax.tree.leaves(jgrads)
    assert len(grads) == len(jgrads)
    for path, got, want in zip(paths, grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_greedy_tokens_equal_reference(arch):
    """The config's bf16 compute: the loss to rtol 2e-2; then a prefill of
    24 (16 frontend positions, 8 tokens) and 8 greedy steps, the tokens
    equal wherever the reference's top-2 margin exceeds 5e-2 (the first
    disagreement ends the comparison)."""
    jc, tc = _cfgs(arch, "bfloat16")
    jp, tp = _models(jc)
    tokens, fe = _inputs(jc, S=32, seed=5)
    jl = jloss(jp, {"tokens": jnp.asarray(tokens),
                    "frontend_embeds": jnp.asarray(fe)}, jc)[0]
    tl = loss_fn(tp, {"tokens": torch.from_numpy(tokens),
                      "frontend_embeds": torch.from_numpy(fe)}, tc)[0]
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-2)
    prompt = tokens[:, :24]
    jlog, jcaches, _ = jprefill(jp, jnp.asarray(prompt), jc,
                                frontend_embeds=jnp.asarray(fe), max_len=32)
    tlog, tcaches, _ = prefill(tp, torch.from_numpy(prompt), tc,
                               frontend_embeds=torch.from_numpy(fe),
                               max_len=32)
    step = jax.jit(lambda p, c, t, pos: jdecode(p, c, t, pos, jc))
    compared = 0
    for t in range(24, 32):
        a, b = _np(jlog[:, -1]), _np(tlog[:, -1])
        jt, tt = a.argmax(-1), b.argmax(-1)
        differ = jt != tt
        if differ.any():
            assert (_margin(a)[differ] <= 5e-2).all(), (t, _margin(a))
            break
        compared += 1
        jlog, jcaches = step(jp, jcaches, jnp.asarray(jt[:, None], jnp.int32),
                             jnp.int32(t))
        tlog, tcaches = decode_step(
            tp, tcaches, torch.from_numpy(tt[:, None].astype(np.int32)), t,
            tc)
    assert compared >= 1


# (B, prompt, max_len, decode steps, long mode): decode_32k's form, a
# linear cache; long_500k's, B 1 in long mode, the prompt filling the
# window's 64 slots and 24 steps wrapping the ring
DECODE_FORMS = {"decode_32k": (2, 40, 48, 8, False),
                "long_500k": (1, 64, None, 24, True)}


@pytest.mark.parametrize("form", sorted(DECODE_FORMS))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_reference(arch, form):
    B, S, max_len, steps, long_mode = DECODE_FORMS[form]
    jc, tc = _cfgs(arch)
    jp, tp = _models(jc)
    tokens, fe = _inputs(jc, B=B, S=S + steps, seed=7)
    prompt = tokens[:, :S]
    jl, jcaches, _ = jprefill(jp, jnp.asarray(prompt), jc,
                              frontend_embeds=jnp.asarray(fe),
                              max_len=max_len)
    tl, tcaches, aux = prefill(tp, torch.from_numpy(prompt), tc,
                               frontend_embeds=torch.from_numpy(fe),
                               max_len=max_len)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    _close_caches(tcaches, jcaches, rtol=1e-5, atol=1e-5)
    assert tcaches["b0"].k.shape[2] == (max_len or S)
    step = jax.jit(lambda p, c, t, pos: jdecode(p, c, t, pos, jc,
                                                long_mode=long_mode))
    for t in range(S, S + steps):
        tok = tokens[:, t:t + 1]
        jl, jcaches = step(jp, jcaches, jnp.asarray(tok), jnp.int32(t))
        tl, tcaches = decode_step(tp, tcaches, torch.from_numpy(tok), t, tc,
                                  long_mode=long_mode)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4,
                                   err_msg=f"step {t}")
    _close_caches(tcaches, jcaches, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_forward(arch):
    """The port alone: a prefill of 36 (16 frontend positions) and 4
    steps track the forward over all 40, the frontend's embeddings in
    both."""
    jc, tc = _cfgs(arch)
    _, tp = _models(jc)
    tokens, fe = _inputs(jc, seed=9)
    tokens, fe = torch.from_numpy(tokens), torch.from_numpy(fe)
    lf = forward(tp, tokens, tc, frontend_embeds=fe)
    logits, caches, _ = prefill(tp, tokens[:, :36], tc, frontend_embeds=fe,
                                max_len=40)
    np.testing.assert_allclose(_np(logits[:, 0]), _np(lf[:, 35]), atol=1e-4)
    for t in range(36, 40):
        ld, caches = decode_step(tp, caches, tokens[:, t:t + 1], t, tc)
        np.testing.assert_allclose(_np(ld[:, 0]), _np(lf[:, t]), atol=1e-4,
                                   err_msg=f"step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_and_inputs_carry_the_frontend(arch):
    """``input_specs`` and ``concrete_inputs`` at a prefill shape hold the
    frontend embeddings ``(B, n, d)`` in the compute dtype, as the
    reference's; the prefill step shards them over the data axis and
    passes them to ``prefill``."""
    from repro.configs import shapes as jshapes
    from repro_torch.configs import shapes as tshapes
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import LaneMesh

    jc, tc = _cfgs(arch)
    jshape = dataclasses.replace(jshapes.SHAPES["prefill_32k"], seq_len=24,
                                 global_batch=2)
    tshape = dataclasses.replace(tshapes.SHAPES["prefill_32k"], seq_len=24,
                                 global_batch=2)
    want = jshapes.input_specs(jc, jshape)
    got = tshapes.input_specs(tc, tshape)
    assert {k: tuple(v.shape) for k, v in want.items()} == \
        {k: tuple(shape) for k, (shape, _) in got.items()}
    assert got["frontend_embeds"] == ((2, 16, jc.d_model), tc.cdtype)
    inputs = tshapes.concrete_inputs(tc, tshape, seed=2, device="cpu")
    assert inputs["frontend_embeds"].shape == (2, 16, jc.d_model)
    step = tsteps.build_prefill_step(tc, LaneMesh(2, "cpu"), shape=tshape)
    assert step.batch_specs["frontend_embeds"] == ("data", None, None)
    _, tp = _models(jc)
    logits, _ = step(tp, inputs)
    want, _, _ = prefill(tp, inputs["tokens"], tc,
                         frontend_embeds=inputs["frontend_embeds"])
    assert torch.equal(logits, want)
    plain, _, _ = prefill(tp, inputs["tokens"], tc)
    assert not torch.equal(logits, plain)


@pytest.fixture(scope="module")
def train_refs(tmp_path_factory):
    return _reference_runs(tmp_path_factory, ARCHS, steps=1)


@pytest.fixture(scope="module", params=ARCHS)
def train_ref(request, train_refs):
    return request.param, train_refs[request.param]


def test_modality_train_step_matches_reference(train_ref):
    """One allgather step (exact engine, density 0.05) on four lanes,
    both packages fed the same frontend embeddings, against the
    reference's on four host devices, under the train test's support-swap
    rule."""
    arch, ref = train_ref
    assert ref["frontend_embeds"].shape[2] == JARCHS[arch].reduced(
        ).frontend_tokens
    paths, _ = _steps_match_reference(ref, arch, steps=1)
    assert ("units", "b0", "attn", "wq", "w") in paths
