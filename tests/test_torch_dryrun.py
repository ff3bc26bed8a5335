"""The port's dry run (``repro_torch.launch.dryrun``): its meta-device
reckoning of one device against the real sharded tensors of that device,
and ``run_one`` on the reference's (16, 16) mesh at full width for the two
models whose embedding the model axis splits on ``d`` there."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.shapes import InputShape, concrete_inputs
from repro_torch.core.distributed import ExchangeConfig, init_state
from repro_torch.launch import dryrun, roofline, sharding
from repro_torch.launch.mesh import MeshShape, production_mesh_shape
from repro_torch.models import model as model_lib

MESH = MeshShape(("data", "model"), (2, 2))
SHAPES = {
    "train": InputShape("t", 16, 4, "train"),
    "prefill": InputShape("p", 16, 4, "prefill"),
    "decode": InputShape("d", 32, 4, "decode"),
    "long": InputShape("l", 64, 1, "decode", long=True),
}


def _real(cfg, shape, ex_cfg):
    """Rank (0, 0)'s real tensors on the CPU at (2, 2), built by the
    port's own loaders: its parts' bytes, and its step's outputs' bytes."""
    whole = model_lib.init_params(cfg, seed=0, device="cpu")
    abstract = model_lib.abstract_params(cfg)
    specs = sharding.param_specs(cfg, abstract, 2)
    hints = sharding.shard_axis_hints(cfg, abstract, 2)
    axis = roofline.MetaAxis(2)
    params = sharding.shard_params(whole, specs, 0, 2)
    parts = {"params": dryrun._nbytes(params)}
    if shape.kind == "train":
        state = init_state(params, ex_cfg, 2, lanes=1, shard_axes=hints,
                           model=axis)
        parts["velocity"] = dryrun._nbytes(state.velocity)
        parts["exchange_state"] = dryrun._nbytes(state.m_shard) \
            + dryrun._nbytes(state.v_shard)
        parts["batch"] = dryrun._nbytes(concrete_inputs(
            cfg, dataclasses.replace(shape, global_batch=2), device="cpu"))
        return parts, None
    if shape.kind == "prefill":
        batch = concrete_inputs(cfg, dataclasses.replace(shape,
                                                         global_batch=2),
                                device="cpu")
        parts["batch"] = dryrun._nbytes(batch)
        logits, caches, _ = model_lib.prefill(
            [params], batch["tokens"], cfg,
            frontend_embeds=batch.get("frontend_embeds"), tp=axis)
        return parts, dryrun._nbytes(logits) + dryrun._nbytes(caches)
    b = 2 if shape.global_batch % 2 == 0 else shape.global_batch
    L = shape.seq_len if b == 2 else shape.seq_len // 2
    caches = model_lib.init_caches(cfg, b, L, long_mode=shape.long,
                                   device="cpu", tp=axis)
    parts["caches"] = dryrun._nbytes(caches)
    parts["batch"] = b * 4 + 4
    return parts, None


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch, mode", [
    ("chatglm3-6b", "allgather"), ("qwen3-moe-235b-a22b", "shardedps"),
    ("mamba2-780m", "shardedps")])
def test_meta_reckoning_equals_real_shards(arch, mode, kind):
    """On (2 data, 2 model), one device's parts reckoned on the meta device
    (parameters, velocity, shardedps M and v, batch rows, caches) equal
    the summed ``numel * element_size`` of the real tensors the port's
    loaders build for rank (0, 0) on the CPU, exactly; so do a prefill's
    outputs (logits and caches)."""
    cfg = get_arch(arch).reduced()
    shape = SHAPES[kind]
    ex_cfg = ExchangeConfig(mode=mode, density=0.05)
    got = dryrun.reckon(cfg, shape, MESH, ex_cfg, remat=False)
    parts, out = _real(cfg, shape, ex_cfg)
    assert got["parts"] == parts
    assert got["argument_bytes"] == sum(parts.values())
    if out is not None:
        assert got["output_bytes"] == out
    if mode == "shardedps" and kind == "train":
        assert parts["exchange_state"] > 0
    assert got["flops"] > 0 and got["collective_counts"]


@pytest.mark.parametrize("arch", ("mamba2-780m", "minicpm3-4b"))
@pytest.mark.parametrize("shape", ("train_4k", "decode_32k"))
def test_run_one_at_full_width_on_the_production_mesh(arch, shape, tmp_path):
    """``run_one`` on the reference's single-pod (16, 16) mesh at the
    published widths: the embedding's vocabulary (50,280; 73,448) does not
    split over 16 shards, so the spec puts it on ``d``; minicpm3's 40 MLA
    heads do not split either.  The row carries the reference's keys,
    ``temp_bytes`` None, and a JSON file."""
    from repro_torch.core.paramspace import tree_flatten
    cfg = get_arch(arch)
    specs = dict(zip(*reversed(tree_flatten(sharding.param_specs(
        cfg, model_lib.abstract_params(cfg), 16)))))
    assert specs[("embed", "table")] == (None, "model")
    row = dryrun.run_one(arch, shape, "single", out_dir=str(tmp_path),
                         verbose=False)
    assert row["temp_bytes"] is None
    assert row["hlo_flops_per_device"] > 0
    assert 0 < row["argument_bytes"] < 80 * 2**30
    assert row["dominant"] in ("compute", "memory", "collective")
    assert (tmp_path / f"{arch}_{shape}_single.json").exists()
    assert production_mesh_shape().n_devices == 256
    assert production_mesh_shape(multi_pod=True).size == 32
    torch.testing.assert_close(row["model_flops"], roofline.model_flops(
        cfg, dryrun.get_shape(shape)))
