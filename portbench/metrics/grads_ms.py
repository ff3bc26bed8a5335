"""Milliseconds a step in the model's loss and gradients (all lanes): CUDA
events around ``TrainStep.grads``, summed over the window's steps and
divided by their count."""


def read(ctx):
    return ctx["ms_total"]["grads"] / ctx["steps"]
