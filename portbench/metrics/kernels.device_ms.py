"""Device milliseconds a step in the program's own kernels (the
``__global__`` functions of the sources its kernel table lists), from the
profiler's window of whole steps."""


def read(ctx):
    prof = ctx.get("profile")
    if prof is None:
        return None
    return 1e3 * prof["port_kernel_s"] / prof["steps"]
