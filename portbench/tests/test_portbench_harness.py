"""The harness finds every cell's files by name, the import guard, the
frozen counts against hand-reckoned values, the token traffic and the
profiler's reduction."""
import math
import re
import types

import numpy as np
import pytest
import torch

from portbench import counts, guard, harness, profile_reduce, ref_dgs, tokens

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_names_units_and_bounds():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for entry in (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                  + BENCH["per_layer"]):
        assert NAME.match(entry["name"]), entry["name"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                              "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = harness.load_cell(name)
    assert set(cell.limits) == {"loss", "grad", "change"}
    assert all(0 < v < 1 for v in cell.limits.values())
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in BENCH["per_layer"]}
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    ref = harness.reference(cell.config)
    layout = ref.layout(cell.config)
    # the program's parameter tree has exactly the reference's leaves
    from repro_torch.models.model import abstract_params
    tree = abstract_params(harness.port_config(cell.config))
    assert {p: tuple(harness.leaf_of(tree, p).shape) for p, _, _ in layout} \
        == {p: tuple(s) for p, s, _ in layout}
    # the count the configuration's file states at its cut
    assert sum(math.prod(s) for _, s, _ in layout) == cell.config["parameters"]


# what a configuration may cut (its depth; the experts and the part of the
# vocabulary one chip of a stated deployment holds), each to no less than
# its floor of the published count
CUTS = {"n_layers": lambda published: 1,
        "moe.n_experts": lambda published: 8,
        "vocab_size": lambda published: -(-published // 8)}


def _value(config, key):
    for part in key.split("."):
        config = config[part]
    return config


def test_configs_keep_published_widths():
    for conf in BENCH["configs"]:
        c = harness.load_json(harness.ROOT / conf["file"])
        for key, cut in c["reduced"].items():
            assert CUTS[key](cut["published"]) <= cut["here"] \
                < cut["published"]
            assert _value(c, key) == cut["here"]
        # BENCHMARK.json names each cut by its key, a nested one by its group
        assert conf["reduced"] == sorted(
            key.split(".")[0] for key in c["reduced"])


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["repro_torch", "repro_torch.core",
                                   "portbench", "jaxtyping"]) == []
    assert guard.forbidden_loaded(["repro.core.engine", "repro_torch"]) \
        == ["repro"]
    assert guard.forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen"]) \
        == ["flax", "jax", "jaxlib"]


def _tiny_gqa():
    return dict(d_model=8, n_heads=2, n_kv_heads=1, head_dim=4, d_ff=16,
                vocab_size=32, n_layers=1, qkv_bias=True,
                compute_dtype="bfloat16", rope_theta=1e4, rotary_pct=0.5)


def test_train_step_flops_by_hand():
    cfg = _tiny_gqa()
    from portbench import ref_gqa
    layout = ref_gqa.layout(cfg)
    # per token: wq 8x8, wk 8x4, wv 8x4, wo 8x8, gate/up 8x16, down 16x8,
    # lm_head 8x32 multiply-adds; the embedding is a lookup
    macs_token = 64 + 32 + 32 + 64 + 128 + 128 + 128 + 256
    # attention: 2 heads x (4 score + 4 value) dims x 3*4/2 query-key pairs
    macs_attention = 1 * 2 * 8 * 6
    traffic = {"batch": 2, "seq": 3}
    assert counts.train_step_flops(cfg, layout, traffic) == \
        6 * (macs_token * 6 + macs_attention * 2)


@pytest.mark.parametrize("router, expert_macs", [(64, 18), (80, 14.4)])
def test_train_step_flops_by_hand_moe(router, expert_macs):
    # one MoE layer holding 8 of the experts its router scores, top-6: of
    # 64 the experts here take 6 * 8 / 64 = 0.75 of a token's choices, of
    # 80 0.6
    cfg = dict(n_layers=1, n_heads=2, head_dim=4, moe=dict(top_k=6))
    layout = [(("embed", "table"), (32, 4), "embedding"),
              (("lm_head", "w"), (4, 32), "matrix"),
              (("units", "b0", "moe", "down"), (1, 8, 2, 4), "matrix"),
              (("units", "b0", "moe", "gate"), (1, 8, 4, 2), "matrix"),
              (("units", "b0", "moe", "router", "w"), (1, 4, router),
               "matrix"),
              (("units", "b0", "moe", "up"), (1, 8, 4, 2), "matrix"),
              (("units", "b0", "norm1", "scale"), (1, 4), "ones")]
    # per token: lm_head 4x32, the router 4 x router, and that share of an
    # expert's gate, up and down (3 x 4 x 2) multiply-adds
    macs_token = 128 + 4 * router + expert_macs
    macs_attention = 1 * 2 * 8 * 6
    traffic = {"batch": 2, "seq": 3}
    assert counts.train_step_flops(cfg, layout, traffic) == \
        pytest.approx(6 * (macs_token * 6 + macs_attention * 2), rel=1e-15)


def test_exchange_least_bytes_by_hand():
    path, shape = ("units", "b0", "mlp", "up", "w"), (1, 8, 16)
    layout = [(path, shape, "matrix")]
    size = 128
    ag = {"workers": 2, "mode": "allgather", "density": 0.25}
    # rows: 16 of 8, k = 32, k_row = 2
    assert ref_dgs.cut(path, shape, "allgather", 0.25, 2) == \
        ref_dgs.Cut(16, 8, 2, 2)
    assert counts.exchange_least_bytes(layout, ag) == \
        2 * 12 * size + 4 * size + 2 * 16 * 2 * 16
    ps = dict(ag, mode="shardedps")
    c = ref_dgs.cut(path, shape, "shardedps", 0.25, 2)
    assert (c.shard_rest, c.cap, c.k2) == (4, 2, 1)
    assert counts.exchange_least_bytes(layout, ps) == \
        2 * 12 * size + 4 * size + 16 * 16 * 4 * 2 + 2 * 16 * (2 * 2 + 1) * 16


def test_tokens_follow_the_seed():
    traffic = {"batch": 3, "seq": 7, "branching": 4, "distinct_batches": 2}
    a = tokens.batches(traffic, 50, 2**31 + 9, "cpu")
    b = tokens.batches(traffic, 50, 2**31 + 9, "cpu")
    c = tokens.batches(traffic, 50, 10, "cpu")
    assert len(a) == 2 and a[0]["tokens"].shape == (3, 7)
    assert all(torch.equal(x["tokens"], y["tokens"]) for x, y in zip(a, b))
    assert not torch.equal(a[0]["tokens"], a[1]["tokens"])
    assert not torch.equal(a[0]["tokens"], c[0]["tokens"])
    # every step is one of the token's successors
    table = tokens.transition(50, 4, 2**31 + 9)
    t = a[1]["tokens"].numpy()
    for row in t:
        for x, y in zip(row[:-1], row[1:]):
            assert y in table[x]


def _ev(name, start, end, device):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=device)


def test_profile_reduction_busy_and_gaps():
    assert profile_reduce._intervals(
        [_ev("k", 5, 7, 1), _ev("k", 0, 2, 1), _ev("k", 1, 3, 1)]) == \
        [[0, 3], [5, 7]]
    host = [_ev("bench/exchange", 0, 10, 0), _ev("aten::sort", 2, 6, 0),
            _ev("aten::copy_", 4, 5, 0), _ev("step", 0, 10, 0)]
    assert profile_reduce._host_labels(host, [1, 3, 4.5, 8]) == [
        "bench/exchange: step", "bench/exchange: aten::sort",
        "bench/exchange: aten::copy_", "bench/exchange: step"]
    names = ["block_topk_sort_kernel", "scatter_add_kernel"]
    assert profile_reduce._is_port_kernel(
        "(anonymous namespace)::block_topk_sort_kernel(float const*)", names)
    assert not profile_reduce._is_port_kernel(
        "void at::native::_scatter_gather_elementwise_kernel<128>", names)


def test_kernel_names_come_from_the_program_sources():
    names = harness._kernel_names()
    assert {"block_topk_sort_kernel", "scatter_add_kernel",
            "rowmap_kernel"} <= set(names)


def test_metric_readers():
    ctx = {"steps": 4, "window_s": 2.0, "flops_per_step": 989e12 * 0.1,
           "exchange_bytes_per_step": 3.35e12 * 0.01,
           "ms_total": {"grads": 40.0, "exchange": 400.0, "apply": 8.0},
           "profile": {"steps": 2, "wall_s": 1.0, "busy_s": 0.75,
                       "port_kernel_s": 0.2}}
    read = {m["name"]: harness.metric_reader(m["name"])(ctx)
            for m in BENCH["per_layer"]}
    assert read == pytest.approx({
        "train.mfu": 20.0, "grads_ms": 10.0, "exchange_ms": 100.0,
        "exchange_roofline": 10.0, "update_ms": 2.0,
        "kernels.device_ms": 100.0, "device.idle_share": 25.0})
    del ctx["profile"]
    assert harness.metric_reader("device.idle_share")(ctx) is None
    assert harness.metric_reader("kernels.device_ms")(ctx) is None


def test_leaf_seeds_take_large_seeds():
    layout = [(("a", "w"), (3, 4), "matrix")]
    x = harness.make_leaf(layout, 0, 2**31 + 77, "cpu")
    y = harness.make_leaf(layout, 0, 2**31 + 77, "cpu")
    z = harness.make_leaf(layout, 0, 2**31 + 78, "cpu")
    assert torch.equal(x, y) and not torch.equal(x, z)
    assert np.isfinite(x.numpy()).all()
