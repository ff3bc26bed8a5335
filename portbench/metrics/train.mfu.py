"""The whole train step's share of the card's bf16 peak, in %: the
configuration's model FLOPs a step (``counts.train_step_flops``: forward
and backward products, no recompute, no embedding lookup) times the
window's steps, over the window's wall time and the 989 TFLOP/s peak."""
from portbench import counts


def read(ctx):
    return (100.0 * ctx["flops_per_step"] * ctx["steps"] / ctx["window_s"]
            / counts.PEAK_BF16_FLOPS)
