"""The port's MoE block (``repro_torch.models.moe``) and the MoE family of
its model on the CPU, against the JAX reference's.

Inputs come from numpy seeds; weights are the reference's, carried across
with ``convert.params_from_numpy``.  Tolerances:

* float32 compute: rtol/atol 1e-5 (router probabilities, aux losses, the
  block's output, logits, losses); gradients rtol 1e-4 / atol 1e-6, as
  ``tests/test_torch_models.py`` holds the dense family's;
* bf16 compute, as the dense family's there: the loss to rtol 2e-2 and
  every gradient leaf to a cosine similarity of at least 0.99, the block's
  output to rtol/atol 2e-2;
* exact: the router's ids wherever its top-k margin (the k-th minus the
  (k+1)-th probability) exceeds 1e-6, its tie order (to the lowest
  expert, as ``lax.top_k``), the capacity path's dispatch (sorted order,
  kept set, slots) and its bf16 combine, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from port_fields import reference_fields

from repro.configs import ARCHS as JARCHS
from repro.core.distributed import rows_view as jrows_view
from repro.core.distributed import shardedps_state_size as jstate_size
from repro.models import moe as jmoe
from repro.models.model import abstract_params as jabstract
from repro.models.model import init_params as jinit
from repro.models.model import loss_fn as jloss
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.core.distributed import ExchangeConfig, leaf_cut
from repro_torch.core.paramspace import tree_flatten, tree_unflatten
from repro_torch.launch.sharding import shard_axis_hints as thints
from repro_torch.models import moe as tmoe
from repro_torch.models.config import MoEConfig as TMoE
from repro_torch.models.layers import Init
from repro_torch.models.model import abstract_params as tabstract
from repro_torch.models.model import init_params as tinit
from repro_torch.models.model import loss_fn as tloss

MOE = ["dbrx-132b", "qwen3-moe-235b-a22b"]
MARGIN = 1e-6


def _pair(name="qwen3-moe-235b-a22b", *, dtype="float32", **moe):
    """(reference config, port config): the reduced ``name`` with
    ``compute_dtype`` and its MoE fields replaced."""
    jc = JARCHS[name].reduced()
    jc = dataclasses.replace(jc, compute_dtype=dtype,
                             moe=dataclasses.replace(jc.moe, **moe))
    tc = dataclasses.replace(
        TARCHS[name].reduced(), compute_dtype=dtype,
        moe=TMoE(**dataclasses.asdict(jc.moe)))
    assert reference_fields(tc) == reference_fields(jc)
    return jc, tc


def _params(jc, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jc)
    return jp, params_from_numpy(jax.device_get(jp), "cpu")


def _x(jc, B=2, S=24, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, S, jc.d_model)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _margins(probs: np.ndarray, k: int) -> np.ndarray:
    """Per token, the k-th largest probability minus the (k+1)-th."""
    top = -np.sort(-probs, axis=-1)
    return top[:, k - 1] - top[:, k] if k < probs.shape[1] \
        else np.full(probs.shape[0], np.inf)


def _assert_ids(got, want, margin):
    live = margin > MARGIN
    assert live.mean() > 0.99, live.mean()
    np.testing.assert_array_equal(np.asarray(got)[live],
                                  np.asarray(want)[live])


def _full_probs(jp, x, jc):
    logits = jnp.asarray(x).reshape(-1, jc.d_model) @ jp["router"]["w"]
    return np.asarray(jax.nn.softmax(logits, axis=-1))


@pytest.mark.parametrize("k,experts", [(2, 8), (4, 16), (1, 4)])
def test_router_probs_ids_and_aux_equal_reference(k, experts):
    jc, tc = _pair(n_experts=experts, top_k=k)
    jp, tp = _params(jc)
    x = _x(jc).reshape(-1, jc.d_model)
    jprob, jids, jaux = jmoe.router_probs(jp, jnp.asarray(x), jc)
    tprob, tids, taux = tmoe.router_probs(tp, torch.from_numpy(x), tc)
    assert tids.shape == (x.shape[0], k) and tprob.dtype == torch.float32
    _assert_ids(tids, jids, _margins(_full_probs(jp, x, jc), k))
    np.testing.assert_allclose(_np(tprob), _np(jprob), rtol=1e-5, atol=1e-5)
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(_np(taux[key]), _np(jaux[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_router_ties_go_to_the_lowest_expert():
    """Duplicated router columns give bit-equal logits: the ids are
    ``lax.top_k``'s (the lowest expert of a tie first), and so is the
    capacity path's dispatch."""
    jc, tc = _pair(n_experts=8, top_k=3, impl="capacity",
                   capacity_factor=0.5)
    jp, _ = _params(jc)
    w = np.array(jp["router"]["w"])
    w[:, 5] = w[:, 2]
    w[:, 7] = w[:, 2]
    w[:, 1] = w[:, 6]
    jp = dict(jp, router={"w": jnp.asarray(w)})
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    x = _x(jc).reshape(-1, jc.d_model)
    _, jids, _ = jmoe.router_probs(jp, jnp.asarray(x), jc)
    _, tids, _ = tmoe.router_probs(tp, torch.from_numpy(x), tc)
    jids = np.asarray(jids)
    np.testing.assert_array_equal(tids.numpy(), jids)
    # the ties were live: both members of a tie chosen, the lower first
    rows = np.nonzero((jids == 2).any(1) & (jids == 5).any(1))[0]
    assert rows.size > 0
    for r in rows:
        assert list(jids[r]).index(2) < list(jids[r]).index(5)
    _check_dispatch(tids, jids, tc)


def _ref_dispatch(ids, cfg):
    """The reference's ``moe_forward_capacity`` lines that route the
    pairs, on its own ids."""
    T, K = ids.shape
    E = cfg.moe.n_experts
    C = max(1, int(round(T * K / E * cfg.moe.capacity_factor)))
    flat_e = jnp.asarray(ids).reshape(-1)
    order = jnp.argsort(flat_e)
    e_s = flat_e[order]
    t_s = jnp.repeat(jnp.arange(T, dtype=jnp.int32), K)[order]
    pos = jnp.arange(T * K, dtype=jnp.int32) - jnp.searchsorted(
        e_s, e_s, side="left").astype(jnp.int32)
    keep = pos < C
    slot = jnp.where(keep, e_s * C + pos, E * C)
    return [np.array(a) for a in (order, e_s, t_s, keep, slot)]


def _check_dispatch(tids, jids, tc):
    got = tmoe.dispatch(tids, tc)
    want = _ref_dispatch(jids, tc)
    for name, a, b in zip(("order", "e_s", "t_s", "keep", "slot"), got,
                          want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    return got


@pytest.mark.parametrize("impl,factor", [("dense", 1.25),
                                         ("capacity", 1.25),
                                         ("capacity", 0.5)])
@pytest.mark.parametrize("name", MOE)
def test_moe_forward_float32_equals_reference(name, impl, factor):
    """The block's output and aux on 48 tokens, 8 experts; the capacity
    path drops the same pairs as the reference's (many at factor 0.5)."""
    jc, tc = _pair(name, n_experts=8, top_k=2 if name == MOE[1] else 4,
                   impl=impl, capacity_factor=factor)
    jp, tp = _params(jc)
    x = _x(jc)
    jout, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jc)
    tout, taux = tmoe.moe_forward(tp, torch.from_numpy(x), tc)
    assert tout.shape == x.shape and tout.dtype == torch.float32
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-5, atol=1e-5)
    for key in jaux:
        np.testing.assert_allclose(_np(taux[key]), _np(jaux[key]),
                                   rtol=1e-5, atol=1e-5)
    if impl == "capacity":
        xf = x.reshape(-1, jc.d_model)
        _, jids, _ = jmoe.router_probs(jp, jnp.asarray(xf), jc)
        _, tids, _ = tmoe.router_probs(tp, torch.from_numpy(xf), tc)
        _assert_ids(tids, jids, _margins(_full_probs(jp, xf, jc),
                                         jc.moe.top_k))
        keep = _check_dispatch(tids, np.asarray(jids), tc)[3]
        if factor < 1:
            assert int((~keep).sum()) > 0


def test_capacity_equals_dense_when_nothing_drops():
    """As the reference's own test: with room for every pair, sort-based
    dispatch gives the dense path's output."""
    jc, tc = _pair(n_experts=8, top_k=2, impl="capacity",
                   capacity_factor=8.0)
    _, tp = _params(jc)
    x = torch.from_numpy(_x(jc))
    cap, _ = tmoe.moe_forward_capacity(tp, x, tc)
    dense, _ = tmoe.moe_forward_dense(tp, x, tc)
    np.testing.assert_allclose(_np(cap), _np(dense), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_tokens,k,experts,factor,want", [
    (10, 1, 4, 1.0, 2),            # 2.5 -> 2: Python's round, half to even
    (6, 2, 8, 1.0, 2),             # 1.5 -> 2
    (128, 8, 128, 1.25, 10),       # qwen3-moe at decode_32k
    (16384, 8, 128, 1.25, 1280),   # qwen3-moe's prefill of 16 x 1,024
    (1, 8, 128, 1.25, 1),          # at least one slot
    (2, 2, 4, 0.5, 1)])
def test_capacity_rounds_half_to_even(n_tokens, k, experts, factor, want):
    _, tc = _pair(n_experts=experts, top_k=k, capacity_factor=factor)
    assert tmoe.capacity(n_tokens, tc) == want == max(
        1, int(round(n_tokens * k / experts * factor)))


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_forward_bf16_equals_reference(factor):
    """bf16 compute: the router in float32 gives the reference's ids above
    the margin and the same dropped set; the output agrees to rtol/atol
    2e-2."""
    jc, tc = _pair(dtype="bfloat16", n_experts=8, top_k=2, impl="capacity",
                   capacity_factor=factor)
    jp, tp = _params(jc)
    x = _x(jc)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    jout, _ = jmoe.moe_forward(jp, xj, jc)
    tout, _ = tmoe.moe_forward(tp, xt, tc)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=2e-2, atol=2e-2)
    _, jids, _ = jmoe.router_probs(jp, xj.reshape(-1, jc.d_model), jc)
    _, tids, _ = tmoe.router_probs(tp, xt.reshape(-1, jc.d_model), tc)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _check_dispatch(tids, np.asarray(jids), tc)


@pytest.mark.parametrize("n_tokens,k,experts,width", [
    (48, 2, 8, 64), (300, 8, 16, 32), (64, 4, 4, 16), (7, 8, 128, 8)])
def test_bf16_combine_is_bit_equal_to_the_reference_scatter(
        n_tokens, k, experts, width):
    """``combine`` on the sorted pairs' contributions in bf16 against the
    reference's ``zeros.at[t_s].add(contrib)`` (eager and under jit), bit
    for bit; the values span many binades, so the order of the adds
    shows."""
    rng = np.random.default_rng(n_tokens)
    ids = np.stack([rng.permutation(experts)[:k]
                    for _ in range(n_tokens)]).astype(np.int32)
    order = np.argsort(ids.reshape(-1), kind="stable")
    t_s = np.repeat(np.arange(n_tokens, dtype=np.int32), k)[order]
    contrib = (rng.normal(size=(n_tokens * k, width))
               * np.exp(3 * rng.normal(size=(n_tokens * k, 1))))
    cj = jnp.asarray(contrib, jnp.bfloat16)

    def scatter(c, t):
        return jnp.zeros((n_tokens, width), jnp.bfloat16).at[t].add(c)

    got = tmoe.combine(torch.from_numpy(contrib).to(torch.bfloat16),
                       torch.from_numpy(order), n_tokens)
    assert got.dtype == torch.bfloat16
    bits = got.view(torch.int16).numpy()
    for want in (scatter(cj, jnp.asarray(t_s)),
                 jax.jit(scatter)(cj, jnp.asarray(t_s))):
        np.testing.assert_array_equal(
            bits, np.asarray(jax.lax.bitcast_convert_type(want, jnp.int16)))


def test_capacity_forward_bf16_combine_bits_from_the_same_contributions():
    """The capacity forward's combine in bf16, fed the reference's own
    expert outputs: bit-equal to the reference's block output.  (The
    experts' bf16 matmuls are the frameworks' own; the combine is not.)"""
    jc, tc = _pair(dtype="bfloat16", n_experts=8, top_k=2, impl="capacity",
                   capacity_factor=0.5)
    jp, _ = _params(jc)
    x = jnp.asarray(_x(jc), jnp.bfloat16).reshape(-1, jc.d_model)
    T, E = x.shape[0], jc.moe.n_experts
    top_p, ids, _ = jmoe.router_probs(jp, x, jc)
    order, _, t_s, keep, slot = _ref_dispatch(np.asarray(ids), jc)
    C = max(1, int(round(T * 2 / E * 0.5)))
    tok = np.full((E * C + 1,), T, np.int32)
    tok[slot] = t_s
    xpad = jnp.concatenate([x, jnp.zeros((1, jc.d_model), x.dtype)])
    out_buf = jmoe._expert_ffn(jp, xpad[tok[:E * C]].reshape(E, C, -1), jc,
                               expert_axis_in_front=True).reshape(E * C, -1)
    p_s = np.asarray(top_p).reshape(-1)[order]
    contrib = jnp.where(jnp.asarray(keep)[:, None],
                        out_buf[np.minimum(slot, E * C - 1)], 0.0) \
        * jnp.asarray(p_s)[:, None].astype(out_buf.dtype)
    want = jmoe.moe_forward_capacity(jp, x[None], jc)[0][0]
    got = tmoe.combine(torch.from_numpy(np.array(
        contrib.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(order), T)
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(jax.lax.bitcast_convert_type(want, jnp.int16)))


def test_moe_init_shapes_scales_and_gate():
    tc = TARCHS["qwen3-moe-235b-a22b"].reduced()
    e, d = tc.moe, tc.d_model
    p = tmoe.moe_init(Init(torch.Generator().manual_seed(0), "cpu"), tc)
    assert p["router"]["w"].shape == (d, e.n_experts)
    assert p["up"].shape == p["gate"].shape == (e.n_experts, d, e.d_expert)
    assert p["down"].shape == (e.n_experts, e.d_expert, d)
    for key, scale in (("up", d ** -0.5), ("gate", d ** -0.5),
                       ("down", e.d_expert ** -0.5)):
        assert float(p[key].abs().max()) <= 2.0 * scale
        assert float(p[key].std()) > 0.5 * scale
    plain = dataclasses.replace(tc, activation="gelu")
    p = tmoe.moe_init(Init(torch.Generator().manual_seed(0), "cpu"), plain)
    assert "gate" not in p


@pytest.mark.parametrize("activation", ["gelu", "silu", "geglu"])
def test_ungated_and_geglu_experts_equal_reference(activation):
    jc, tc = _pair(n_experts=4, top_k=2, impl="capacity")
    jc = dataclasses.replace(jc, activation=activation)
    tc = dataclasses.replace(tc, activation=activation)
    jp, tp = _params(jc)
    x = _x(jc)
    jout, _ = jmoe.moe_forward(jp, jnp.asarray(x), jc)
    tout, _ = tmoe.moe_forward(tp, torch.from_numpy(x), tc)
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-5, atol=1e-5)


def _loss_and_grads(jc, tc, tokens, *, remat=False):
    jp = jinit(jax.random.PRNGKey(0), jc)
    batch = {"tokens": jnp.asarray(tokens)}
    (jl, jm), jg = jax.value_and_grad(lambda p: jloss(p, batch, jc),
                                      has_aux=True)(jp)
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    leaves, paths = tree_flatten(tp)
    for leaf in leaves:
        leaf.requires_grad_()
    tl, tm = tloss(tp, {"tokens": torch.from_numpy(tokens)}, tc,
                   remat=remat)
    tg = torch.autograd.grad(tl, leaves)
    return (jl, jm, jax.tree.leaves(jg)), (tl, tm, tg), paths


GRAD_CASES = {
    "dense": dict(impl="dense"),
    "capacity": dict(impl="capacity"),
    # 8 experts: qwen3's top-8 of 8, dbrx's top-4 of 8, pairs dropped
    "capacity_drops": dict(impl="capacity", n_experts=8, top_k=None,
                           capacity_factor=0.5),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
@pytest.mark.parametrize("name", MOE)
def test_loss_and_grads_float32_equal_reference(name, case):
    """``loss_fn`` with the router's aux losses, and every gradient leaf,
    against ``jax.value_and_grad`` of the reference's."""
    moe = dict(GRAD_CASES[case])
    if moe.get("top_k", 0) is None:
        moe["top_k"] = min(JARCHS[name].moe.top_k, moe["n_experts"])
    jc, tc = _pair(name, **moe)
    tokens = np.random.default_rng(2).integers(
        0, jc.vocab_size, (2, 32)).astype(np.int32)
    (jl, jm, jg), (tl, tm, tg), paths = _loss_and_grads(jc, tc, tokens)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-5)
    assert set(tm) == set(jm) == {"nll", "load_balance", "router_z"}
    for key in jm:
        np.testing.assert_allclose(_np(tm[key]), _np(jm[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    assert float(tm["load_balance"].detach()) > 0
    assert float(tm["router_z"].detach()) > 0
    assert len(tg) == len(jg)
    for path, got, want in zip(paths, tg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("name", MOE)
def test_loss_and_grads_bf16_compute(name):
    jc, tc = _pair(name, dtype="bfloat16", impl="capacity")
    tokens = np.random.default_rng(4).integers(
        0, jc.vocab_size, (2, 32)).astype(np.int32)
    (jl, _, jg), (tl, _, tg), paths = _loss_and_grads(jc, tc, tokens)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-2)
    for path, got, want in zip(paths, tg, jg):
        a = got.double().numpy().reshape(-1)
        b = np.asarray(want, np.float64).reshape(-1)
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 0.99, (path, cos)


def test_remat_gives_the_same_moe_gradients_and_aux():
    """The checkpointed units return the aux too: the same loss, metrics
    and gradients bit for bit."""
    _, tc = _pair(impl="capacity", n_experts=8, top_k=2,
                  capacity_factor=0.5)
    params = tinit(tc, seed=1, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, tc.vocab_size, (2, 32)).astype(np.int32))
    out = []
    for remat in (False, True):
        leaves, paths = tree_flatten(params)
        live = [x.detach().requires_grad_() for x in leaves]
        loss, metrics = tloss(tree_unflatten(paths, live),
                              {"tokens": tokens}, tc, remat=remat)
        out.append((loss, metrics, torch.autograd.grad(loss, live)))
    (l0, m0, g0), (l1, m1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("mode", ["allgather", "shardedps"])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", MOE)
def test_expert_leaves_are_cut_as_the_reference_exchange(name, reduced, mode):
    """Every leaf of the MoE models' trees (the experts stacked over the
    units: (units, E, d, f), the expert axis hinted), as ``leaf_cut`` cuts
    it: the reference exchange's row view, per-row k and shardedps state
    size."""
    jc, tc = JARCHS[name], TARCHS[name]
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    shapes = tabstract(tc)
    leaves, paths = tree_flatten(shapes)
    assert [tuple(x.shape) for x in leaves] == [
        tuple(x.shape) for x in jax.tree.leaves(jabstract(jc))]
    hints = thints(tc, shapes, 1)
    ex = ExchangeConfig(mode=mode, density=0.05)
    W = 4
    experts = 0
    for path, leaf, ax in zip(paths, leaves, hints):
        shape = tuple(leaf.shape)
        if "moe" in path and path[-1] in ("up", "gate", "down"):
            assert len(shape) == 4 and ax == 1, (path, shape, ax)
            experts += 1
        c = leaf_cut(shape, ax, ex, W)
        size = int(np.prod(shape))
        k = max(1, min(size, int(round(size * ex.density))))
        if mode == "allgather" and (ax is None or len(shape) == 1) \
                and size < (1 << 24):
            assert c.flat, path
            continue
        S, rest, rax = jrows_view(shape, ax if ax is not None else 0) \
            if mode == "allgather" else jrows_view(shape, ax)
        assert (c.S, c.rest) == (S, rest), path
        assert c.k_row == max(1, min(rest, -(-k // S))), path
        if mode == "shardedps":
            assert c.S * c.shard_rest == jstate_size(shape, ax, W), path
    assert experts == 3


@pytest.mark.parametrize("name", ["chatglm3-6b", "qwen3-moe-235b-a22b"])
def test_loss_metrics_keys_equal_reference(name):
    """``loss_fn``'s metrics are the reference's: ``nll``,
    ``load_balance`` and ``router_z`` for every family, zeros for the
    dense one."""
    jc = dataclasses.replace(JARCHS[name].reduced(), compute_dtype="float32")
    tc = dataclasses.replace(TARCHS[name].reduced(), compute_dtype="float32")
    tokens = np.random.default_rng(5).integers(
        0, jc.vocab_size, (2, 16)).astype(np.int32)
    jp = jinit(jax.random.PRNGKey(0), jc)
    _, jm = jloss(jp, {"tokens": jnp.asarray(tokens)}, jc)
    _, tm = tloss(params_from_numpy(jax.device_get(jp), "cpu"),
                  {"tokens": torch.from_numpy(tokens)}, tc)
    assert sorted(tm) == sorted(jm) == ["load_balance", "nll", "router_z"]
    for key in jm:
        np.testing.assert_allclose(_np(tm[key]), _np(jm[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    if tc.moe is None:
        assert float(tm["load_balance"]) == float(tm["router_z"]) == 0.0


@pytest.mark.parametrize("name", MOE)
def test_init_params_seeded_with_the_moe_tree(name):
    tc = TARCHS[name].reduced()
    a = tinit(tc, seed=3, device="cpu")
    b = tinit(tc, seed=3, device="cpu")
    la, paths = tree_flatten(a)
    assert all(torch.equal(x, y) for x, y in zip(la, tree_flatten(b)[0]))
    moe = a["units"]["b0"]["moe"]
    n_units = tc.unit_pattern()[1]
    assert moe["up"].shape == (n_units, tc.moe.n_experts, tc.d_model,
                               tc.moe.d_expert)
    assert moe["router"]["w"].shape == (n_units, tc.d_model,
                                        tc.moe.n_experts)
    assert "mlp" not in a["units"]["b0"]
