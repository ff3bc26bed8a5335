"""Deterministic synthetic data (PyTorch port of ``ClassificationTask`` from
``repro.data.synthetic``): gaussian-blobs classification, the CIFAR
stand-in of the paper's convergence experiments.

Batches come from ``torch.Generator``s seeded from ``(seed, step, worker)``
on the CPU and are then moved to ``device`` (None = the card), so the card
and the CPU see the same batches.  They are not the reference's ``jax.random`` bits: tests that
compare the two packages feed both the same numpy batches.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def seeded_generator(*words: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded from a tuple of integers."""
    seed = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed) >> 1)


@dataclasses.dataclass(frozen=True)
class ClassificationTask:
    n_features: int = 64
    n_classes: int = 10
    batch_size: int = 32
    seed: int = 0
    noise: float = 0.6
    device: Any = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def centers(self) -> torch.Tensor:
        return torch.randn((self.n_classes, self.n_features),
                           generator=seeded_generator(self.seed + 999))

    def _draw(self, gen: torch.Generator, n: int):
        y = torch.randint(0, self.n_classes, (n,), generator=gen)
        x = self.centers()[y] + self.noise * torch.randn(
            (n, self.n_features), generator=gen)
        return x.to(self.device), y.to(self.device)

    def batch(self, step: int, worker: int = 0):
        return self._draw(seeded_generator(self.seed, step, worker),
                          self.batch_size)

    def eval_set(self, n: int = 512):
        return self._draw(seeded_generator(self.seed + 31337), n)
