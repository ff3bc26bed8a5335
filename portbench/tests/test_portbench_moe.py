"""The reference exchange follows the program's over a mixture-of-experts
model's leaves (experts, router, attention, embedding) on the CPU: the
program's train step over 4 lanes, its gradients replaced by seeded ones
that the reference's workers get too, three steps in both modes.  The
model's configuration reaches the program as a configuration file's
mapping does, through ``harness.port_config``."""
import dataclasses

import pytest
import torch

from portbench import harness, ref_dgs

W, STEPS, LR, MOMENTUM, DENSITY = 4, 3, 0.05, 0.9, 0.05


def _moe_config():
    """The program's own reduced qwen3-moe configuration, as a file holds
    it (its nested parts as mappings), built back through the harness."""
    from repro_torch.configs import get_arch

    cfg = get_arch("qwen3-moe-235b-a22b").reduced(d_model=64, vocab=64)
    mapping = dataclasses.asdict(cfg)
    assert isinstance(mapping["moe"], dict)
    built = harness.port_config(mapping)
    assert built == cfg
    return built


def test_a_moe_mapping_builds_the_program_tree():
    from repro_torch.models.model import abstract_params

    cfg = _moe_config()
    tree = abstract_params(cfg)
    e = cfg.moe
    assert tuple(tree["units"]["b0"]["moe"]["up"].shape) == \
        (cfg.n_layers, e.n_experts, cfg.d_model, e.d_expert)
    assert tuple(tree["units"]["b0"]["moe"]["router"]["w"].shape) == \
        (cfg.n_layers, cfg.d_model, e.n_experts)
    with pytest.raises(TypeError):
        harness.port_config(dict(dataclasses.asdict(cfg),
                                 moe=dict(n_experts=8, top_k=2, d_expert=8,
                                          no_such_key=1)))


@pytest.mark.parametrize("mode", ["allgather", "shardedps"])
def test_reference_exchange_follows_the_program_on_experts(mode):
    from repro_torch.core.distributed import ExchangeConfig
    from repro_torch.core.paramspace import tree_flatten, tree_unflatten
    from repro_torch.launch.mesh import LaneMesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import abstract_params

    cfg = _moe_config()
    ex = ExchangeConfig(mode=mode, density=DENSITY, momentum=MOMENTUM,
                        engine="blockwise", quantize="none",
                        bucket_factor=2.0)
    step = build_train_step(cfg, LaneMesh(W, "cpu"), ex, lr=LR, remat=False)
    shapes, paths = tree_flatten(abstract_params(cfg))
    shapes = [tuple(s.shape) for s in shapes]
    assert any(p[-2] == "moe" for p in paths)
    gen = torch.Generator().manual_seed(2**31 + 21)
    p0 = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn((W,) + s, generator=gen) for s in shapes]
             for _ in range(STEPS)]
    feed = iter(grads)
    step.grads = lambda params, batch: (tree_unflatten(paths, next(feed)),
                                        torch.zeros(W))
    tree = tree_unflatten(paths, [p.clone() for p in p0])
    state = step.init_state(tree)

    cuts = [ref_dgs.cut(p, s, mode, DENSITY, W) for p, s in zip(paths, shapes)]
    workers = [ref_dgs.Worker() for _ in range(W)]
    ref = [p.clone() for p in p0]
    batch = {"tokens": torch.zeros((W, 2), dtype=torch.int32)}
    for i in range(STEPS):
        tree, state, _ = step(tree, state, batch)
        for j, (path, shape) in enumerate(zip(paths, shapes)):
            ref[j] -= ref_dgs.exchange_leaf(
                workers, path, list(grads[i][j]), shape, cuts[j], mode,
                MOMENTUM, LR)
        if i == 0:
            # the velocity norms as the comparison reads them
            prog_v = {p: harness._norm(harness.leaf_of(state.velocity, p))
                      for p in paths}
            ref_v = {p: ref_dgs.velocity_norm(workers, p) for p in paths}
            assert harness.worst_gap(prog_v, ref_v, paths) < 1e-6
    prog = tree_flatten(tree)[0]
    for path, a, b, start in zip(paths, prog, ref, p0):
        change = harness._norm(b - start)
        assert change > 0, path
        assert harness._norm(a - b) <= 1e-6 * change, path
