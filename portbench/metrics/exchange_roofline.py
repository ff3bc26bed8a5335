"""The exchange's share of its memory roofline, in %: the least time its
work takes at 3.35 TB/s (``counts.exchange_least_bytes``, reckoned from
the leaves' shapes, W and the k's) over the measured exchange time a
step."""
from portbench import counts


def read(ctx):
    ms = ctx["ms_total"]["exchange"] / ctx["steps"]
    least_ms = 1e3 * ctx["exchange_bytes_per_step"] / counts.HBM_BYTES_PER_S
    return 100.0 * least_ms / ms
