"""The share of the profiler's window of whole steps in which no operation
ran on the device, in %."""


def read(ctx):
    prof = ctx.get("profile")
    if prof is None:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
