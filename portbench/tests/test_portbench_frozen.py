"""A freeze of the four first cells' readings as the harness took them
before it knew mixture-of-experts and SSM leaves: the step's model FLOPs
behind ``train.mfu``, the exchange's least bytes behind
``exchange_roofline``, and every leaf's cut of the reference exchange
(S, rest, ax, k_row, shard_rest, cap, k2).  Widening the harness for
other leaf kinds must not move a number of these cells."""
import pytest

from portbench import counts, harness, ref_dgs

FROZEN = {
    "chatglm3-6b.allgather.s128": {
        "flops": 8_297_977_479_168,
        "bytes": 51_924_455_488,
        "cuts": {
            "embed/table": (65024, 4096, 0, 205, 0, 0, 0),
            "final_norm/scale": (1, 4096, None, 205, 0, 0, 0),
            "lm_head/w": (65024, 4096, 1, 205, 0, 0, 0),
            "units/b0/attn/wk/b": (256, 2, 1, 1, 0, 0, 0),
            "units/b0/attn/wk/w": (256, 8192, 2, 410, 0, 0, 0),
            "units/b0/attn/wo/w": (4096, 8192, 1, 410, 0, 0, 0),
            "units/b0/attn/wq/b": (4096, 2, 1, 1, 0, 0, 0),
            "units/b0/attn/wq/w": (4096, 8192, 2, 410, 0, 0, 0),
            "units/b0/attn/wv/b": (256, 2, 1, 1, 0, 0, 0),
            "units/b0/attn/wv/w": (256, 8192, 2, 410, 0, 0, 0),
            "units/b0/mlp/down/w": (13696, 8192, 1, 410, 0, 0, 0),
            "units/b0/mlp/gate/w": (13696, 8192, 2, 410, 0, 0, 0),
            "units/b0/mlp/up/w": (13696, 8192, 2, 410, 0, 0, 0),
            "units/b0/norm1/scale": (1, 8192, None, 410, 0, 0, 0),
            "units/b0/norm2/scale": (1, 8192, None, 410, 0, 0, 0),
        },
    },
    "minicpm3-4b.allgather.s128": {
        "flops": 3_860_767_703_040,
        "bytes": 27_677_802_944,
        "cuts": {
            "embed/table": (73448, 2560, 0, 128, 0, 0, 0),
            "final_norm/scale": (1, 2560, None, 128, 0, 0, 0),
            "lm_head/w": (73448, 2560, 1, 128, 0, 0, 0),
            "units/b0/attn/kv_norm/scale": (1, 512, None, 26, 0, 0, 0),
            "units/b0/attn/q_norm/scale": (1, 1536, None, 77, 0, 0, 0),
            "units/b0/attn/wkv_a/w": (1, 1474560, None, 73728, 0, 0, 0),
            "units/b0/attn/wkv_b/w": (5120, 512, 2, 26, 0, 0, 0),
            "units/b0/attn/wo/w": (2560, 5120, 1, 256, 0, 0, 0),
            "units/b0/attn/wq_a/w": (1, 3932160, None, 196608, 0, 0, 0),
            "units/b0/attn/wq_b/w": (3840, 1536, 2, 77, 0, 0, 0),
            "units/b0/mlp/down/w": (6400, 5120, 1, 256, 0, 0, 0),
            "units/b0/mlp/gate/w": (6400, 5120, 2, 256, 0, 0, 0),
            "units/b0/mlp/up/w": (6400, 5120, 2, 256, 0, 0, 0),
            "units/b0/norm1/scale": (1, 5120, None, 256, 0, 0, 0),
            "units/b0/norm2/scale": (1, 5120, None, 256, 0, 0, 0),
        },
    },
    "chatglm3-6b.allgather.s4096": {
        "flops": 278_317_102_006_272,
        "bytes": 51_924_455_488,
        "cuts": {
            "embed/table": (65024, 4096, 0, 205, 0, 0, 0),
            "final_norm/scale": (1, 4096, None, 205, 0, 0, 0),
            "lm_head/w": (65024, 4096, 1, 205, 0, 0, 0),
            "units/b0/attn/wk/b": (256, 2, 1, 1, 0, 0, 0),
            "units/b0/attn/wk/w": (256, 8192, 2, 410, 0, 0, 0),
            "units/b0/attn/wo/w": (4096, 8192, 1, 410, 0, 0, 0),
            "units/b0/attn/wq/b": (4096, 2, 1, 1, 0, 0, 0),
            "units/b0/attn/wq/w": (4096, 8192, 2, 410, 0, 0, 0),
            "units/b0/attn/wv/b": (256, 2, 1, 1, 0, 0, 0),
            "units/b0/attn/wv/w": (256, 8192, 2, 410, 0, 0, 0),
            "units/b0/mlp/down/w": (13696, 8192, 1, 410, 0, 0, 0),
            "units/b0/mlp/gate/w": (13696, 8192, 2, 410, 0, 0, 0),
            "units/b0/mlp/up/w": (13696, 8192, 2, 410, 0, 0, 0),
            "units/b0/norm1/scale": (1, 8192, None, 410, 0, 0, 0),
            "units/b0/norm2/scale": (1, 8192, None, 410, 0, 0, 0),
        },
    },
    "chatglm3-6b.dualway.s128": {
        "flops": 8_297_977_479_168,
        "bytes": 70_721_146_816,
        "cuts": {
            "embed/table": (65024, 4096, 0, 205, 1024, 102, 51),
            "final_norm/scale": (1, 4096, None, 205, 1024, 102, 51),
            "lm_head/w": (65024, 4096, 1, 205, 1024, 102, 51),
            "units/b0/attn/wk/b": (256, 2, 1, 1, 1, 1, 1),
            "units/b0/attn/wk/w": (256, 8192, 2, 410, 2048, 205, 102),
            "units/b0/attn/wo/w": (4096, 8192, 1, 410, 2048, 205, 102),
            "units/b0/attn/wq/b": (4096, 2, 1, 1, 1, 1, 1),
            "units/b0/attn/wq/w": (4096, 8192, 2, 410, 2048, 205, 102),
            "units/b0/attn/wv/b": (256, 2, 1, 1, 1, 1, 1),
            "units/b0/attn/wv/w": (256, 8192, 2, 410, 2048, 205, 102),
            "units/b0/mlp/down/w": (13696, 8192, 1, 410, 2048, 205, 102),
            "units/b0/mlp/gate/w": (13696, 8192, 2, 410, 2048, 205, 102),
            "units/b0/mlp/up/w": (13696, 8192, 2, 410, 2048, 205, 102),
            "units/b0/norm1/scale": (1, 8192, None, 410, 2048, 205, 102),
            "units/b0/norm2/scale": (1, 8192, None, 410, 2048, 205, 102),
        },
    },
}


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_cell_readings_are_frozen(name):
    cell = harness.load_cell(name)
    layout = harness.reference(cell.config).layout(cell.config)
    tr = cell.traffic
    want = FROZEN[name]
    assert counts.train_step_flops(cell.config, layout, tr) == want["flops"]
    assert counts.exchange_least_bytes(layout, tr) == want["bytes"]
    cuts = {"/".join(path): tuple(ref_dgs.cut(
        path, shape, tr["mode"], tr["density"], tr["workers"],
        tr.get("bucket_factor", 2.0))) for path, shape, _ in layout}
    assert cuts == want["cuts"]
