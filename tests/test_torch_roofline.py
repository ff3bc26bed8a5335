"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
reference's ``repro.launch.roofline``: the analytic ``model_flops`` for
every architecture and input shape, the report's fields; and its own
counts: ``FlopCounterMode`` on the meta device against real CPU tensors,
and the exchange's static wire bytes against the bytes the exchange's
collectives move."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.launch import roofline as jax_roofline

from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.core.distributed import ExchangeConfig
from repro_torch.core.paramspace import (tree_flatten, tree_leaves,
                                         tree_unflatten)
from repro_torch.launch import roofline
from repro_torch.launch.mesh import LaneMesh
from repro_torch.launch.steps import _local_params, build_train_step
from repro_torch.models import model as model_lib


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_equal_reference(arch):
    """``model_flops`` of every architecture at each of the four shapes
    equals the reference's, exactly."""
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    assert sorted(SHAPES) == sorted(JAX_SHAPES)
    for name in SHAPES:
        assert roofline.model_flops(get_arch(arch), SHAPES[name]) == \
            jax_roofline.model_flops(jax_get_arch(arch), JAX_SHAPES[name])


def test_model_flops():
    """The reference's ``test_launch.py`` case: 6 N D to train, 2 N a
    sequence to decode (rel 1e-6)."""
    cfg = get_arch("chatglm3-6b")
    f_train = roofline.model_flops(cfg, SHAPES["train_4k"])
    assert f_train == pytest.approx(6 * cfg.param_count() * 4096 * 256,
                                    rel=1e-6)
    f_dec = roofline.model_flops(cfg, SHAPES["decode_32k"])
    assert f_dec == pytest.approx(2 * cfg.param_count() * 128, rel=1e-6)


def test_moe_active_params():
    """The reference's ``test_launch.py`` case: ~22B active parameters of
    the 235B MoE."""
    cfg = get_arch("qwen3-moe-235b-a22b")
    f = roofline.model_flops(cfg, SHAPES["train_4k"])
    assert 1.5e10 < f / (6 * 4096 * 256) < 3.5e10


def test_report_row_keys_equal_reference():
    """``RooflineReport``'s fields and ``row()``'s keys are the
    reference's; the terms are the card's: FLOPs over the compute dtype's
    peak, bytes over the H100's memory rate, wire bytes over the link."""
    assert [f.name for f in dataclasses.fields(roofline.RooflineReport)] \
        == [f.name for f in dataclasses.fields(jax_roofline.RooflineReport)]
    kw = dict(arch="a", shape="s", mesh="m", flops_per_device=1.0,
              bytes_per_device=2.0, wire_bytes_per_device=3.0,
              collective_counts={}, compute_s=1.0, memory_s=2.0,
              collective_s=0.5, model_flops=8.0, n_devices=2)
    assert roofline.RooflineReport(**kw).row().keys() == \
        jax_roofline.RooflineReport(**kw).row().keys()
    cfg = get_arch("chatglm3-6b")
    r = roofline.report(arch="chatglm3-6b", shape=SHAPES["train_4k"],
                        mesh_name="single", cfg=cfg, n_devices=256,
                        flops=989e12, nbytes=3.35e12, wire=450e9,
                        collective_counts={"sum": 1})
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, 1.0)
    assert roofline.hbm_rate("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.hbm_rate("NVIDIA H100 PCIe") == 2.0e12


def _meta(tree):
    leaves, paths = tree_flatten(tree)
    return tree_unflatten(paths, [torch.empty_like(x, device="meta")
                                  for x in leaves])


@pytest.mark.parametrize("arch, M", [
    ("chatglm3-6b", 1), ("qwen3-moe-235b-a22b", 1), ("mamba2-780m", 1),
    ("chatglm3-6b", 2), ("minicpm3-4b", 2)])
def test_flop_count_on_meta_equals_real_tensors(arch, M):
    """``FlopCounterMode`` over one device's train step (forward and
    backward), prefill and decode of a reduced model counts the same
    FLOPs on the meta device as on real CPU tensors; at model size 2 one
    rank's step through ``MetaAxis``, whose collectives it counts (the
    same on both)."""
    cfg = dataclasses.replace(get_arch(arch).reduced(),
                              compute_dtype="float32")
    params = model_lib.init_params(cfg, seed=0, device="cpu")
    if M > 1:
        params = _local_params(params, cfg, LaneMesh(1, "cpu", model=M))[0]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))

    def counts(p, tok):
        axis = roofline.MetaAxis(M)
        tp = axis if M > 1 else None
        local = [p] if M > 1 else p
        leaves, paths = tree_flatten(p)

        def train():
            live = [x.detach().requires_grad_() for x in leaves]
            tree = tree_unflatten(paths, live)
            loss = model_lib.loss_fn([tree] if M > 1 else tree,
                                     {"tokens": tok}, cfg, tp=tp)[0]
            torch.autograd.grad(loss, live)

        def serve():
            _, caches, _ = model_lib.prefill(local, tok, cfg, max_len=20,
                                             tp=tp)
            model_lib.decode_step(local, caches, tok[:, :1], 16, cfg, tp=tp)

        return (roofline.count_flops(train), roofline.count_flops(serve),
                dict(axis.counts), axis.wire_bytes)

    real = counts(params, tokens)
    meta = counts(_meta(params), tokens.to("meta"))
    assert real == meta
    assert real[0] > 0 and real[1] > 0
    assert bool(real[2]) == (M > 1)


class _TapMesh(LaneMesh):
    """A ``LaneMesh`` that sums the bytes one worker receives from each
    collective: the whole gathered array, and its row of an
    all-to-all."""

    received = 0

    def gather(self, x):
        self.received += x.numel() * x.element_size()
        return super().gather(x)

    def all_to_all(self, x):
        self.received += x.numel() * x.element_size() // x.shape[0]
        return super().all_to_all(x)


@pytest.mark.parametrize("mode, wire_dtype", [
    ("allgather", "float32"), ("allgather", "bfloat16"),
    ("shardedps", "float32")])
def test_wire_bytes_equal_what_the_exchange_moves(mode, wire_dtype):
    """``roofline.wire_bytes`` (``chip_smoke.py``'s per-worker bytes of
    phase H) equals the bytes each worker receives from the exchange's
    collectives in a step of the reduced chatglm3-6b on 4 lanes (every
    weight cut into rows, the norm scales whole), exactly."""
    cfg = get_arch("chatglm3-6b").reduced()
    mesh = _TapMesh(4, "cpu")
    step = build_train_step(cfg, mesh, ExchangeConfig(
        mode=mode, density=0.05, wire_dtype=wire_dtype), remat=False)
    params = model_lib.init_params(cfg, seed=0, device="cpu")
    state = step.init_state(params)
    grads, _ = step.grads(params, {"tokens": torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16))
        .astype(np.int32))})
    step.exchange(state, grads)
    want = roofline.wire_bytes(step.ex_cfg, 4,
                               [p.shape for p in tree_leaves(params)],
                               step.hints)
    assert mesh.received == want


def test_reckoned_step_of_a_production_cell():
    """The wire bytes at model size 16: a hinted leaf's rows split over the
    shards, a leaf cut whole not, against the whole count at model size
    1."""
    cfg = get_arch("chatglm3-6b")
    from repro_torch.launch import sharding
    whole = model_lib.abstract_params(cfg)
    ex = ExchangeConfig(mode="allgather", density=0.01)
    shapes = [p.shape for p in tree_leaves(whole)]
    one = roofline.wire_bytes(ex, 16, shapes,
                              sharding.shard_axis_hints(cfg, whole, 1))
    hints = sharding.shard_axis_hints(cfg, whole, 16)
    split = roofline.wire_bytes(ex, 16, shapes, hints, 16)
    assert 0 < split < one
    assert sum(h is None for h in hints) > 0
