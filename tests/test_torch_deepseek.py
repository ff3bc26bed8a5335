"""DeepSeek-V2's parts of the port on the CPU: YaRN's frequencies and
softmax scale against the closed form at the published widths, the
dropless MoE over held experts against the dense dispatch, its bits run
to run, the leading dense layer and the query without a latent in the
parameter tree, and the MoE's spans and device counters through a
train step's recorder (once a forward, remat or not; the recorder changes
no bit)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.core.distributed import ExchangeConfig
from repro_torch.core.paramspace import tree_flatten, tree_unflatten
from repro_torch.launch.mesh import LaneMesh
from repro_torch.launch.steps import build_train_step
from repro_torch.models import attention, moe, rope
from repro_torch.models.config import (MLAConfig, ModelConfig, MoEConfig,
                                       RopeScaling)
from repro_torch.models.layers import Init
from repro_torch.models.model import abstract_params, init_params

YARN = RopeScaling(type="yarn", factor=40, original_max_position_embeddings=4096,
                   beta_fast=32, beta_slow=1, mscale=0.707, mscale_all_dim=0.707)


def _cfg(dtype="float32", **moe_kw):
    """A tiny DeepSeek-V2-shaped model: one dense layer, then two MoE
    layers holding experts 4..7 of a 16-wide router, top-3, with shared
    experts, raw weights and the sequence loss."""
    kw = dict(n_experts=4, top_k=3, d_expert=8, impl="dropless",
              router_aux_weight=0.001, n_router=16, first_expert=4,
              n_shared=2, norm_topk=False, balance="sequence")
    kw.update(moe_kw)
    return ModelConfig(
        name="tiny-deepseek", arch_type="moe", n_layers=3, d_model=16,
        n_heads=2, n_kv_heads=2, d_ff=24, vocab_size=32, attention="mla",
        mla=MLAConfig(q_lora_rank=None, kv_lora_rank=8, qk_nope_head_dim=4,
                      qk_rope_head_dim=8, v_head_dim=4),
        moe=MoEConfig(**kw), rope_scaling=YARN, first_k_dense_replace=1,
        compute_dtype=dtype)


def test_yarn_frequencies_at_the_published_rope_dims():
    dim, theta = 64, 10000.0
    base = theta ** -(np.arange(0, dim, 2, dtype=np.float64) / dim)
    got = rope._yarn_freqs(dim, theta, YARN)
    # corr(32) = 10.47 and corr(1) = 22.51: pairs up to 10 keep their
    # frequency, pairs from 23 on turn 40 times slower, a ramp between
    np.testing.assert_allclose(got[:11], base[:11], rtol=1e-15)
    np.testing.assert_allclose(got[23:], base[23:] / 40, rtol=1e-15)
    ramp = (np.arange(11, 23) - 10) / 13
    np.testing.assert_allclose(got[11:23],
                               base[11:23] * (1 - ramp) + base[11:23] / 40 * ramp,
                               rtol=1e-14)
    # cos and sin are not scaled: mscale / mscale_all_dim is 1
    pos = torch.arange(5)
    cos, sin = rope.rope_cos_sin(pos, dim, theta, YARN)
    ang = pos[:, None].float() * torch.from_numpy(got.astype(np.float32))
    assert torch.equal(cos[:, 0::2], torch.cos(ang))
    assert torch.equal(sin[:, 1::2], torch.sin(ang))


def test_mla_scale_takes_yarns_mscale_squared():
    cfg = dataclasses.replace(
        _cfg(), mla=MLAConfig(q_lora_rank=None, kv_lora_rank=512,
                              qk_nope_head_dim=128, qk_rope_head_dim=64,
                              v_head_dim=128))
    m = 0.1 * 0.707 * math.log(40) + 1
    assert m * m == pytest.approx(1.5896, abs=1e-4)
    assert attention.mla_scale(cfg) == pytest.approx(192 ** -0.5 * m * m,
                                                     rel=1e-15)
    # without YaRN the scale is MiniCPM3's, to the bit
    plain = dataclasses.replace(cfg, rope_scaling=None)
    assert attention.mla_scale(plain) == 192 ** -0.5


def test_the_tree_has_the_dense_layer_and_a_query_without_latent():
    tree = abstract_params(_cfg())
    assert set(tree["dense"]) == {"l0"}
    assert set(tree["dense"]["l0"]["mlp"]) == {"gate", "up", "down"}
    assert tuple(tree["dense"]["l0"]["mlp"]["up"]["w"].shape) == (16, 24)
    unit = tree["units"]["b0"]
    assert {"wq", "wkv_a", "kv_norm", "wkv_b", "wo"} == set(unit["attn"])
    assert tuple(unit["attn"]["wq"]["w"].shape) == (2, 16, 2 * 12)
    assert tuple(unit["moe"]["up"].shape) == (2, 4, 16, 8)
    assert tuple(unit["moe"]["router"]["w"].shape) == (2, 16, 16)
    assert tuple(unit["moe"]["shared"]["down"]["w"].shape) == (2, 16, 16)
    # embedding, head and final norm 1,040; the dense layer 2,088 (norms
    # 32, attention 904, MLP 1,152); each MoE layer 3,496 (norms 32,
    # attention 904, router 256, 4 experts 1,536, shared 768)
    leaves, _ = tree_flatten(tree)
    assert sum(leaf.numel() for leaf in leaves) == 1_040 + 2_088 + 2 * 3_496


def _moe_params(cfg, seed=0):
    return moe.moe_init(Init(torch.Generator().manual_seed(seed), "cpu"), cfg)


def _moe_grads(p, x, cfg):
    """(out, aux, {leaf: grad}, x's grad) of the MoE layer with a fixed
    cotangent."""
    leaves, paths = tree_flatten(p)
    live = [t.detach().clone().requires_grad_() for t in leaves]
    xx = x.detach().clone().requires_grad_()
    out, aux = moe.moe_forward(tree_unflatten(paths, live), xx, cfg)
    g = torch.linspace(-1, 1, out.numel()).reshape(out.shape).to(out.dtype)
    loss = (out.float() * g.float()).sum() + aux["load_balance"]
    grads = torch.autograd.grad(loss, live + [xx])
    return out, aux, dict(zip(paths, grads[:-1])), grads[-1]


@pytest.mark.parametrize("first", [0, 4, 12])
def test_dropless_equals_dense_dispatch_on_the_held_experts(first):
    cfg = _cfg(first_expert=first)
    p = _moe_params(cfg)
    x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(1))
    a = _moe_grads(p, x, cfg)
    b = _moe_grads(p, x, dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, impl="dense")))
    torch.testing.assert_close(a[0], b[0], rtol=1e-6, atol=1e-6)
    assert torch.equal(a[1]["load_balance"], b[1]["load_balance"])
    for path in a[2]:
        torch.testing.assert_close(a[2][path], b[2][path], rtol=1e-5,
                                   atol=1e-6, msg=str(path))
    torch.testing.assert_close(a[3], b[3], rtol=1e-5, atol=1e-6)


def test_dropless_gives_the_same_bits_twice():
    cfg = _cfg(dtype="bfloat16")
    p = _moe_params(cfg, seed=3)
    x = torch.randn(4, 8, 16, generator=torch.Generator().manual_seed(4)
                    ).to(torch.bfloat16)
    a, b = _moe_grads(p, x, cfg), _moe_grads(p, x, cfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[3], b[3])
    assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])


def test_sequence_balance_by_hand():
    # two sequences of two tokens, top-1 of a router of 2: sequence 0
    # sends both tokens to expert 0, sequence 1 one to each
    probs = torch.tensor([[0.75, 0.25], [0.5, 0.5], [0.75, 0.25],
                          [0.25, 0.75]])
    ids = torch.tensor([[0], [0], [0], [1]])
    got = moe.sequence_balance(probs, ids, 2, 2)
    # f = R / (K S) * counts: (2, 0) and (1, 1); P the mean probability
    want = ((2 * 0.625 + 0 * 0.375) + (1 * 0.5 + 1 * 0.5)) / 2
    assert float(got) == pytest.approx(want, rel=1e-7)


def _step(recorder, cfg, seed=0, remat=False):
    """Two train steps of the tiny model on 4 lanes; (params, the last
    loss)."""
    ex = ExchangeConfig(mode="allgather", density=0.25, momentum=0.9,
                        engine="blockwise", quantize="none")
    step = build_train_step(cfg, LaneMesh(4, "cpu"), ex, lr=0.05,
                            remat=remat)
    step.recorder = recorder
    params = init_params(cfg, seed=seed, device="cpu")
    state = step.init_state(params)
    gen = torch.Generator().manual_seed(seed + 1)
    for _ in range(2):
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 8),
                                         generator=gen)}
        params, state, loss = step(params, state, batch)
    return params, loss


@pytest.mark.parametrize("remat", [False, True])
def test_moe_spans_and_counters_through_the_step(remat):
    cfg = _cfg(dtype="bfloat16")
    rec = telemetry.Recorder()
    params, loss = _step(rec, cfg, remat=remat)
    tot = rec.totals()
    # 2 steps x 4 lanes x 2 MoE layers, once each: the backward's
    # recompute of a rematerialised forward records nothing
    for name in ("moe/route", "moe/dispatch", "moe/experts", "moe/combine",
                 "moe/shared"):
        assert tot[name]["count"] == 16, name
    spans = [e for e in rec._trace if e["name"] == "moe/experts"]
    assert {(e["args"]["lane"], e["args"]["layer"]) for e in spans} == {
        (lane, layer) for lane in range(4) for layer in (1, 2)}
    assert all(e["args"]["parent"] == "grads/forward" for e in spans)
    tallies = rec.tallies()
    assert set(tallies) == {"moe.pairs_held", "moe.group_max"}
    assert not set(tallies) & set(tot)
    assert tallies["moe.pairs_held"]["count"] == 16
    assert tallies["moe.group_max"]["count"] == 16
    assert 0 < tallies["moe.group_max"]["value"] <= 16
    assert tallies["moe.group_max"]["value"] * 4 >= (
        tallies["moe.pairs_held"]["value"] / 16)
    if remat:
        plain = telemetry.Recorder()
        _step(plain, cfg)
        assert tallies == plain.tallies()
    # the recorder changes no bit
    ref, ref_loss = _step(telemetry.NULL, cfg, remat=remat)
    assert torch.equal(loss, ref_loss)
    for a, b in zip(tree_flatten(params)[0], tree_flatten(ref)[0]):
        assert torch.equal(a, b)


def test_held_pairs_count_the_routing():
    cfg = _cfg()
    p = _moe_params(cfg, seed=5)
    x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(6))
    rec = telemetry.Recorder()
    with telemetry.trace.recording(rec, lane=0):
        moe.moe_forward(p, x, cfg, layer=3)
    _, ids, _ = moe.router_probs(p, x.reshape(16, 16), cfg, seq_len=8)
    held = (ids >= 4) & (ids < 8)
    sizes = torch.bincount(ids[held] - 4, minlength=4)
    tallies = rec.tallies()
    assert tallies["moe.pairs_held"]["value"] == int(held.sum())
    assert tallies["moe.group_max"]["value"] == int(sizes.max())
    assert {e["args"]["layer"] for e in rec._trace} == {3}
