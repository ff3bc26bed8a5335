"""The port's model zoo slice on the CPU, against the JAX reference's.

* The ten architectures' configs field for field, ``param_count`` and
  ``reduced()``; ``input_specs`` for training.
* ``shard_axis_hints`` for every architecture at ``model_size`` 1 and 2
  (pure path logic, over the reference's parameter shapes), and the port's
  parameter tree (keys, shapes) for the families it runs.
* rmsnorm, swiglu, partial rope and ``gqa_forward`` (full and sliding
  masks, the window's K/V slice) on the same numpy inputs.
* ``loss_fn`` and its gradients from the reference's ``init_params``
  carried across by ``params_from_numpy``: float32 compute to rtol 1e-5
  (loss) and 1e-4 / atol 1e-6 (every gradient leaf); the config's bf16
  compute to rtol 2e-2 (loss) and a cosine similarity of at least 0.99
  per gradient leaf.
* the modality families (qwen2-vl-7b's M-RoPE, musicgen-large's
  frames) with and without their frontend embeddings: the loss to rtol
  1e-5 and every gradient leaf to rtol 1e-4 / atol 1e-6, float32.
* ``TokenStream``'s transition table is the reference's, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from port_fields import reference_fields

from repro.configs import ARCHS as JARCHS
from repro.configs.shapes import InputShape as JShape
from repro.configs.shapes import input_specs as jinput_specs
from repro.data.synthetic import TokenStream as JStream
from repro.launch.sharding import param_specs as jparam_specs
from repro.launch.sharding import shard_axis_hints as jhints
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import rope as jrope
from repro.models.model import abstract_params as jabstract
from repro.models.model import init_params as jinit
from repro.models.model import loss_fn as jloss
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs.shapes import InputShape as TShape
from repro_torch.configs.shapes import input_specs as tinput_specs
from repro_torch.convert import params_from_numpy
from repro_torch.core.paramspace import tree_flatten
from repro_torch.data.synthetic import TokenStream as TStream
from repro_torch.launch.sharding import param_specs as tparam_specs
from repro_torch.launch.sharding import shard_axis_hints as thints
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import rope as trope
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.config import MoEConfig as TMoE
from repro_torch.models.model import abstract_params as tabstract
from repro_torch.models.model import init_params as tinit
from repro_torch.models.model import loss_fn as tloss

NAMES = sorted(JARCHS)
# the architectures whose parameter trees the port makes: all ten (dense
# GQA, MLA, MoE, SSM, hybrid, and the modality ones)
PORTED = NAMES
CHATGLM = "chatglm3-6b"


def _port_cfg(cfg):
    """The port's ModelConfig with the reference config's fields."""
    moe = None if cfg.moe is None else TMoE(**dataclasses.asdict(cfg.moe))
    return dataclasses.replace(
        TARCHS[cfg.name.removesuffix("-reduced")], moe=moe, **{
            f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(cfg)
            if f.name not in ("moe", "mla", "ssm")})


@pytest.mark.parametrize("name", NAMES)
def test_config_fields_count_and_reduced(name):
    jc, tc = JARCHS[name], TARCHS[name]
    assert reference_fields(tc) == reference_fields(jc)
    assert tc.param_count() == jc.param_count()
    assert str(tc.pdtype).removeprefix("torch.") == str(jc.pdtype)
    assert str(tc.cdtype).removeprefix("torch.") == str(jc.cdtype)
    assert reference_fields(tc.reduced()) == reference_fields(jc.reduced())
    assert tc.reduced().param_count() == jc.reduced().param_count()
    assert tc.layer_kinds() == jc.layer_kinds()
    assert tc.unit_pattern() == jc.unit_pattern()


def test_train_input_specs():
    cfg = TARCHS[CHATGLM]
    for shape in ((JShape("train_4k", 4096, 256, "train"),
                   TShape("train_4k", 4096, 256, "train")),):
        want = jinput_specs(JARCHS[CHATGLM], shape[0])
        got = tinput_specs(cfg, shape[1])
        assert {k: tuple(v.shape) for k, v in want.items()} == \
            {k: s for k, (s, _) in got.items()}
        assert got["tokens"][1] is torch.int32


def _meta_tree(tree):
    """A reference shape tree as meta tensors (nested dicts)."""
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), device="meta")


@pytest.mark.parametrize("model_size", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_shard_axis_hints_equal_reference(name, model_size):
    jc, tc = JARCHS[name], TARCHS[name]
    shapes = jabstract(jc)
    assert thints(tc, _meta_tree(shapes), model_size) == \
        jhints(jc, shapes, model_size)
    t_specs = tree_flatten(tparam_specs(tc, _meta_tree(shapes), model_size))
    j_specs = jax.tree.leaves(jparam_specs(jc, shapes, model_size),
                              is_leaf=lambda x: isinstance(x, P))
    assert list(t_specs[0]) == [tuple(p) for p in j_specs]
    if name in PORTED:
        # the port's own tree: the reference's keys and shapes
        t_leaves, t_paths = tree_flatten(tabstract(tc))
        j_flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        assert t_paths == tuple(tuple(p.key for p in path)
                                for path, _ in j_flat)
        assert [tuple(x.shape) for x in t_leaves] == \
            [tuple(x.shape) for _, x in j_flat]


def _close(got: torch.Tensor, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def test_rmsnorm_swiglu_and_partial_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    scale = rng.normal(size=64).astype(np.float32)
    _close(tlayers.rmsnorm({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(x)),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    p = {k: {"w": rng.normal(size=s).astype(np.float32) * 0.1}
         for k, s in (("gate", (64, 96)), ("up", (64, 96)),
                      ("down", (96, 64)))}
    for act in ("swiglu", "geglu", "gelu", "silu"):
        _close(tlayers.mlp(params_from_numpy(p, "cpu"), torch.from_numpy(x),
                           activation=act),
               jlayers.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           activation=act), rtol=1e-4, atol=1e-5)
    q = rng.normal(size=(2, 8, 4, 128)).astype(np.float32)
    k = rng.normal(size=(2, 8, 2, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8)).copy()
    for dtype in (np.float32, jnp.bfloat16):
        tq, tk = trope.standard_rope(
            torch.from_numpy(q).to(getattr(torch, np.dtype(dtype).name)),
            torch.from_numpy(k).to(getattr(torch, np.dtype(dtype).name)),
            torch.from_numpy(pos), theta=10000.0, rotary_dim=64)
        jq, jk = jrope.standard_rope(jnp.asarray(q, dtype),
                                     jnp.asarray(k, dtype),
                                     jnp.asarray(pos), theta=10000.0,
                                     rotary_dim=64)
        assert tq.dtype == getattr(torch, np.dtype(jq.dtype).name)
        tol = 1e-5 if dtype == np.float32 else 1e-2
        _close(tq, jnp.asarray(jq, jnp.float32), rtol=tol, atol=tol)
        _close(tk, jnp.asarray(jk, jnp.float32), rtol=tol, atol=tol)
        # the second half of each head is left alone
        np.testing.assert_array_equal(tq[..., 64:].float().numpy(),
                                      np.asarray(jnp.asarray(q, dtype)
                                                 [..., 64:], np.float32))


@pytest.mark.parametrize("variant", ["chatglm", "sliding", "local"])
def test_gqa_forward_equals_reference(variant):
    jc = dataclasses.replace(JARCHS[CHATGLM].reduced(),
                             compute_dtype="float32")
    layer_kind, chunk_q = "attn", 512
    if variant == "sliding":
        jc = dataclasses.replace(jc, attention="sliding", window=8)
        chunk_q = 8      # window + chunk < S: the K/V slice per chunk
    if variant == "local":
        jc = dataclasses.replace(jc, attention="local_global", window=8,
                                 rope_theta_local=500.0)
        layer_kind, chunk_q = "attn_local", 16
    tc = _port_cfg(jc)
    jp = jattn.gqa_init(jax.random.PRNGKey(3), jc)
    # nonzero biases, so the qkv bias is exercised
    jp = jax.tree.map(lambda a: a + 0.01 if a.ndim == 1 else a, jp)
    rng = np.random.default_rng(1)
    S = 32
    x = rng.normal(size=(2, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    want = jattn.gqa_forward(jp, jnp.asarray(x), jnp.asarray(pos), jc,
                             layer_kind=layer_kind, chunk_q=chunk_q)
    got = tattn.gqa_forward(params_from_numpy(jax.device_get(jp), "cpu"),
                            torch.from_numpy(x), torch.from_numpy(pos), tc,
                            layer_kind=layer_kind, chunk_q=chunk_q)
    _close(got, want, rtol=1e-4, atol=1e-5)


def _loss_and_grads(jc, tokens):
    """(reference loss, reference grads, port loss, port grads) from the
    reference's initial parameters."""
    jp = jinit(jax.random.PRNGKey(0), jc)
    batch = {"tokens": jnp.asarray(tokens)}
    jl, jg = jax.value_and_grad(lambda p: jloss(p, batch, jc)[0])(jp)
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    leaves, paths = tree_flatten(tp)
    for leaf in leaves:
        leaf.requires_grad_()
    tl = tloss(tp, {"tokens": torch.from_numpy(tokens)}, _port_cfg(jc))[0]
    tg = torch.autograd.grad(tl, leaves)
    return jl, jax.tree.leaves(jg), tl, tg, paths


FAMILIES = {
    "chatglm3-reduced": {},
    "tied-layernorm-gelu": dict(tie_embeddings=True, norm="layernorm",
                                activation="gelu", qkv_bias=False),
    "sinusoidal": dict(rope="none", activation="geglu"),
    "local_global": dict(attention="local_global", local_global_ratio=1,
                         n_layers=4, window=8, rope_theta_local=500.0),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grads_float32(family):
    jc = dataclasses.replace(JARCHS[CHATGLM].reduced(),
                             compute_dtype="float32", **FAMILIES[family])
    tokens = np.random.default_rng(2).integers(
        0, jc.vocab_size, (2, 32)).astype(np.int32)
    jl, jg, tl, tg, paths = _loss_and_grads(jc, tokens)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert len(tg) == len(jg)
    for path, got, want in zip(paths, tg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=str(path))


def test_loss_and_grads_bf16_compute():
    jc = JARCHS[CHATGLM].reduced()
    assert jc.compute_dtype == "bfloat16"
    tokens = np.random.default_rng(4).integers(
        0, jc.vocab_size, (2, 32)).astype(np.int32)
    jl, jg, tl, tg, paths = _loss_and_grads(jc, tokens)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-2)
    for path, got, want in zip(paths, tg, jg):
        a = got.double().numpy().reshape(-1)
        b = np.asarray(want, np.float64).reshape(-1)
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 0.99, (path, cos)


def test_init_params_seeded_and_shaped():
    tc = TARCHS[CHATGLM].reduced()
    a, b = tinit(tc, seed=5, device="cpu"), tinit(tc, seed=5, device="cpu")
    la, paths = tree_flatten(a)
    lb = tree_flatten(b)[0]
    for x, y, z in zip(la, lb, tree_flatten(tabstract(tc))[0]):
        assert torch.equal(x, y) and x.shape == z.shape
    table = a["embed"]["table"]
    assert float(table.abs().max()) <= 2.0 * tc.d_model ** -0.5
    assert not torch.equal(table, tinit(tc, seed=6, device="cpu")["embed"]
                           ["table"])


def test_init_params_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tinit(TARCHS[CHATGLM].reduced())


@pytest.mark.parametrize("name", ["musicgen-large", "qwen2-vl-7b"])
def test_other_families_raise(name):
    """The modality families give the reference's loss and gradients
    (float32 compute), with their frontend embeddings and without
    (qwen2-vl's M-RoPE over the patch grid's positions either way)."""
    jc = dataclasses.replace(JARCHS[name].reduced(), compute_dtype="float32")
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jc.vocab_size, (2, 24)).astype(np.int32)
    fe = rng.normal(size=(2, jc.frontend_tokens, jc.d_model)).astype(
        np.float32)
    jp = jinit(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    leaves, paths = tree_flatten(tp)
    for leaf in leaves:
        leaf.requires_grad_()
    for with_fe in (True, False):
        jbatch = {"tokens": jnp.asarray(tokens)}
        tbatch = {"tokens": torch.from_numpy(tokens)}
        if with_fe:
            jbatch["frontend_embeds"] = jnp.asarray(fe)
            tbatch["frontend_embeds"] = torch.from_numpy(fe)
        jl, jg = jax.value_and_grad(lambda p: jloss(p, jbatch, jc)[0])(jp)
        tl = tloss(tp, tbatch, _port_cfg(jc))[0]
        tg = torch.autograd.grad(tl, leaves)
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
        for path, got, want in zip(paths, tg, jax.tree.leaves(jg)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{path} fe={with_fe}")


def test_token_stream_table_and_walk():
    js = JStream(vocab_size=512, seq_len=16, batch_size=4, seed=3)
    ts = TStream(vocab_size=512, seq_len=16, batch_size=4, seed=3,
                 device="cpu")
    np.testing.assert_array_equal(ts.transition(),
                                  np.asarray(js._transition()))
    tokens = ts.batch(7)["tokens"]
    assert tokens.shape == (4, 16) and tokens.dtype == torch.int32
    nxt = ts.transition()
    t = tokens.numpy()
    for b in range(4):
        for i in range(15):
            assert t[b, i + 1] in nxt[t[b, i]]
    assert torch.equal(ts.batch(7)["tokens"], tokens)
    assert not torch.equal(ts.batch(8)["tokens"], tokens)


def test_port_config_has_torch_dtypes():
    cfg = TConfig(name="t", arch_type="dense", n_layers=1, d_model=8,
                  n_heads=2, n_kv_heads=1, d_ff=16, vocab_size=32)
    assert cfg.pdtype is torch.float32 and cfg.cdtype is torch.bfloat16
