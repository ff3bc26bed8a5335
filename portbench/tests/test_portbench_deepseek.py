"""DeepSeek-V2-Lite's configuration against its plain reference on the
CPU: the program's loss and every leaf's gradient at the reference's
``TINY`` widths (no query latent, YaRN and its softmax scale, experts
held from ``first_expert`` on, shared experts, raw top-k weights, the
sequence loss, the leading dense layer); the chip's share of the
experts, two shares adding up to the uncut layer; and, for every
configuration file of the benchmark at its published widths, the
reference exchange's cut of every leaf equal to the program's."""
import copy

import pytest
import torch

from portbench import harness, ref_dgs
from portbench import ref_deepseek_v2 as ref
from portbench.ref_gqa import Precision

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CONFIG = "portbench/configs/deepseek-v2-lite-9l.json"
W = 4


def _tiny(**moe):
    config = copy.deepcopy(harness.load_json(harness.ROOT / CONFIG))
    config.update(copy.deepcopy(ref.TINY))
    config["moe"].update(moe)
    return config


def _program_loss_and_grads(params, tokens, config):
    from repro_torch.models.model import loss_fn

    live = {p: t.detach().clone().requires_grad_() for p, t in params.items()}
    loss, _ = loss_fn(harness.to_tree(live), {"tokens": tokens},
                      harness.port_config(config))
    grads = torch.autograd.grad(loss, list(live.values()))
    return float(loss.detach()), dict(zip(live, grads))


@pytest.mark.parametrize("first", [0, 4])
def test_loss_and_every_gradient_follow_the_reference(first):
    config = _tiny(first_expert=first)
    params = harness.make_params(ref.layout(config), 2**31 + 41, "cpu")
    tokens = torch.randint(0, config["vocab_size"], (4, 8),
                           generator=torch.Generator().manual_seed(first))
    loss, grads = _program_loss_and_grads(params, tokens, config)
    want_loss, want = ref.loss_and_grads(params, tokens, config,
                                         Precision("bf16"))
    # the same products in the same dtypes; sums of more than two terms
    # may add in another order
    assert loss == pytest.approx(want_loss, rel=1e-6)
    assert set(grads) == set(want)
    for path, g in grads.items():
        gap = float((g - want[path]).norm() / want[path].norm())
        assert gap < 1e-6, path


class _Float32:
    """The reference's products in float32 (no rounding of operands)."""

    kind = "fp32"

    @staticmethod
    def matmul(x, w):
        return x.float() @ w.float()


def _layer_params(config, seed):
    layout = [e for e in ref.layout(config) if e[0][:3] == ("units", "b0", "moe")]
    params = harness.make_params(layout, seed, "cpu")
    return {p[3:]: t[0] for p, t in params.items()}


def test_two_shares_add_up_to_the_uncut_layer():
    """Experts 0..7 and 8..15 of a 16-wide router on two chips: their
    routed parts, with the shared experts counted once, are the layer
    that holds all 16."""
    from repro_torch.models.moe import moe_forward

    whole = _tiny(n_experts=16, n_router=16, first_expert=0)
    whole["compute_dtype"] = "float32"
    p = _layer_params(whole, 7)
    x = torch.randn(2, 8, whole["d_model"],
                    generator=torch.Generator().manual_seed(8))
    want, want_balance = ref.moe(_Float32(), p, x, whole)

    def tree(q):
        return {"router": {"w": q[("router", "w")]},
                "gate": q[("gate",)], "up": q[("up",)], "down": q[("down",)],
                "shared": {k: {"w": q[("shared", k, "w")]}
                           for k in ("gate", "up", "down")}}

    outs = []
    for first in (0, 8):
        share = copy.deepcopy(whole)
        share["moe"].update(n_experts=8, first_expert=first)
        q = dict(p)
        for k in ("gate", "up", "down"):
            q[(k,)] = p[(k,)][first:first + 8]
        out, aux = moe_forward(tree(q), x, harness.port_config(share))
        assert float(aux["load_balance"]) == pytest.approx(
            float(want_balance), rel=1e-6)
        outs.append(out)
    shared = ref.ffn(_Float32(), {k: p[("shared", k, "w")]
                                  for k in ("gate", "up", "down")},
                     x.reshape(-1, whole["d_model"])).reshape(x.shape)
    torch.testing.assert_close(outs[0] + outs[1] - shared, want,
                               rtol=1e-5, atol=1e-6)


def _program_cut(shape, hint, mode):
    from repro_torch.core.distributed import ExchangeConfig, leaf_cut

    c = leaf_cut(shape, hint, ExchangeConfig(mode=mode, density=0.05), W)
    return (c.S, c.rest, c.ax, c.k_row, c.shard_rest, c.cap, c.k2)


@pytest.mark.parametrize("mode", ["allgather", "shardedps"])
@pytest.mark.parametrize("conf", [c["file"] for c in BENCH["configs"]])
def test_reference_cuts_each_configuration_as_the_program(conf, mode):
    from repro_torch.core.paramspace import tree_flatten
    from repro_torch.launch.sharding import shard_axis_hints
    from repro_torch.models.model import abstract_params

    config = harness.load_json(harness.ROOT / conf)
    cfg = harness.port_config(config)
    tree = abstract_params(cfg)
    leaves, paths = tree_flatten(tree)
    assert {p: tuple(t.shape) for p, t in zip(paths, leaves)} == {
        p: tuple(s) for p, s, _ in harness.reference(config).layout(config)}
    for path, leaf, hint in zip(paths, leaves,
                                shard_axis_hints(cfg, tree, 1)):
        shape = tuple(leaf.shape)
        assert tuple(ref_dgs.cut(path, shape, mode, 0.05, W)) == \
            _program_cut(shape, hint, mode), path
