"""The whole train step's share of the card's bf16 peak, in %: the
configuration's model FLOPs a step (``counts.train_step_flops``: forward
and backward products, no recompute, no embedding lookup; a routed
expert tensor, ``moe``'s ``gate``, ``up`` or ``down`` with three core
dims (``ref_dgs.is_expert``), counts ``top_k / E_router`` of its size a
token, ``E_router`` the router's output width, so that only
the tokens routed to the experts held here count) times the window's
steps, over the window's wall time and the 989 TFLOP/s peak."""
from portbench import counts


def read(ctx):
    return (100.0 * ctx["flops_per_step"] * ctx["steps"] / ctx["window_s"]
            / counts.PEAK_BF16_FLOPS)
