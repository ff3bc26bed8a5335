"""Milliseconds a step in the DGS exchange: CUDA events around
``TrainStep.exchange``, summed over the window's steps and divided by
their count."""


def read(ctx):
    return ctx["ms_total"]["exchange"] / ctx["steps"]
