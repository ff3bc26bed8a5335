"""Milliseconds a step in the parameter update: CUDA events around
``TrainStep.apply``, summed over the window's steps and divided by their
count."""


def read(ctx):
    return ctx["ms_total"]["apply"] / ctx["steps"]
