"""The reference exchange cuts every leaf kind of the program's zoo into
the rows the program's exchange cuts it into, so that the two select over
the same supports: on meta tensors at the published widths, a period of
layers deep, at model size 1, in both modes."""
import dataclasses

import pytest

from repro_torch.configs import ARCHS

from portbench import ref_dgs

W = 4
MODES = ["allgather", "shardedps"]
DENSITIES = [0.05, 0.001]


def _program_cut(shape, hint, mode, density):
    from repro_torch.core.distributed import ExchangeConfig, leaf_cut

    c = leaf_cut(shape, hint, ExchangeConfig(mode=mode, density=density), W)
    return (c.S, c.rest, c.ax, c.k_row, c.shard_rest, c.cap, c.k2)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reference_cuts_as_the_program(arch, mode, density):
    from repro_torch.core.paramspace import tree_flatten
    from repro_torch.launch.sharding import shard_axis_hints
    from repro_torch.models.model import abstract_params

    cfg = ARCHS[arch]
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.unit_pattern()[0]))
    tree = abstract_params(cfg)
    leaves, paths = tree_flatten(tree)
    hints = shard_axis_hints(cfg, tree, 1)
    for path, leaf, hint in zip(paths, leaves, hints):
        shape = tuple(leaf.shape)
        assert tuple(ref_dgs.cut(path, shape, mode, density, W)) == \
            _program_cut(shape, hint, mode, density), path


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(4, 8, 2048, 1408), (4, 8, 1408, 2048)])
@pytest.mark.parametrize("name", ["gate", "up", "down"])
def test_expert_rows_fold_the_layers(name, shape, mode):
    # DeepSeek-V2-Lite's experts, 8 a chip, 4 layers: rows of the expert
    # dim hold 11.5M entries, so the layers fold into them
    path = ("units", "b0", "moe", name)
    c = ref_dgs.cut(path, shape, mode, 0.05, W)
    assert (c.S, c.rest, c.ax) == (32, 2_883_584, 1)
    assert tuple(c) == _program_cut(shape, 1, mode, 0.05)
