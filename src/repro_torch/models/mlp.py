"""The benchmarks' MLP classifier as an ``nn.Module`` (port of
``benchmarks/common.py``'s ``mlp_init``/``mlp_apply``): layers ``w{i}``
(in, out) and ``b{i}``, ReLU between layers, and a cross-entropy
``grad_fn`` on ``torch.autograd`` -- the counterpart of the reference's
``jax.value_and_grad`` functions.

``loss``, ``grad_fn`` and ``accuracy`` compute from the ``params`` dict they
are given and never touch the module's own parameters, so many threads (the
cluster's clients) may call them on one model at once.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device


class MLP(nn.Module):
    """``dims = (in, hidden..., out)``; layer i is named ``w{start+i}`` /
    ``b{start+i}`` (the quickstart numbers from 1, the benchmarks from 0).
    Weights are N(0, 1) * ``scale`` (default sqrt(2 / fan_in)) from a
    seeded generator on the CPU, biases zero; both then live on ``device``
    (None = the card)."""

    def __init__(self, dims, *, start: int = 0, seed: int = 0,
                 scale: float | None = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.names = []
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            s = (2.0 / a) ** 0.5 if scale is None else scale
            w = torch.randn((a, b), generator=gen) * s
            j = start + i
            self.register_parameter(f"w{j}", nn.Parameter(w.to(device)))
            self.register_parameter(
                f"b{j}", nn.Parameter(torch.zeros(b, device=device)))
            self.names.append((f"w{j}", f"b{j}"))

    def logits(self, params: dict, x):
        """The network at ``params`` (a dict keyed like the parameters)."""
        h = x
        for i, (w, b) in enumerate(self.names):
            h = h @ params[w] + params[b]
            if i < len(self.names) - 1:
                h = torch.relu(h)
        return h

    def forward(self, x):
        return self.logits(dict(self.named_parameters()), x)

    def params(self) -> dict:
        """The weights as a plain dict of tensors (the trainer's tree)."""
        return {k: v.detach().clone() for k, v in self.named_parameters()}

    def loss(self, params: dict, batch):
        """Mean cross-entropy of the model at ``params`` on ``(x, y)``."""
        x, y = batch
        return nn.functional.cross_entropy(self.logits(params, x), y)

    def grad_fn(self, params: dict, batch):
        """(loss, grads) at ``params`` -- the trainer's ``grad_fn``."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss = self.loss(leaves, batch)
            grads = torch.autograd.grad(loss, tuple(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    @torch.no_grad()
    def accuracy(self, params: dict, batch) -> float:
        x, y = batch
        pred = self.logits(params, x).argmax(-1)
        return float((pred == y).float().mean())
