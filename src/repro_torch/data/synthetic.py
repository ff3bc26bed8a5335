"""Deterministic synthetic data (PyTorch port of ``repro.data.synthetic``):
markov-chain token sequences for LM training, gaussian-blobs
classification, the CIFAR stand-in of the paper's convergence
experiments, and the delayed-copy task of its LSTM experiment.

Random draws come from ``torch.Generator``s seeded from ``(seed, step,
worker)`` on the CPU and are then moved to ``device`` (None = the card),
so the card and the CPU see the same batches.  They are not the
reference's ``jax.random`` bits: tests that compare the two packages feed
both the same numpy batches.  ``TokenStream``'s transition table is the
reference's own numpy draw, bit for bit.
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
class TokenStream:
    """Markov-chain token sequences: a fixed random transition table (each
    token has ``branching`` successors) gives the stream learnable
    structure.  ``batch(step)`` is stateless."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    branching: int = 8   # out-degree of the markov chain
    device: Any = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def transition(self) -> np.ndarray:
        """The ``(vocab, branching)`` successor table, the reference's
        ``np.random.default_rng(seed)`` draw."""
        rng = np.random.default_rng(self.seed)
        nxt = rng.integers(0, self.vocab_size,
                           (self.vocab_size, self.branching))
        return nxt.astype(np.int32)

    def batch(self, step: int, *, batch_size: int | None = None):
        """``{"tokens": (B, seq_len) int32}`` on the device: ``tok0`` and
        the branch choices from ``seeded_generator(seed, step)``, the walk
        through the table on the device."""
        B = batch_size or self.batch_size
        gen = seeded_generator(self.seed, step)
        tok = torch.randint(0, self.vocab_size, (B,), generator=gen)
        branches = torch.randint(0, self.branching, (B, self.seq_len - 1),
                                 generator=gen)
        nxt = torch.from_numpy(self.transition()).to(self.device)
        tok, branches = tok.to(self.device), branches.to(self.device)
        cols = [tok.to(torch.int32)]
        for t in range(self.seq_len - 1):
            tok = nxt[tok, branches[:, t]].to(torch.int64)
            cols.append(tok.to(torch.int32))
        return {"tokens": torch.stack(cols, dim=1)}


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


@dataclasses.dataclass(frozen=True)
class SequenceCopyTask:
    """Emit a marker, a payload of ``copy_len`` symbols in [2, vocab), then
    ``delay`` blanks, then expect the payload back: an LSTM-friendly
    memory task.  ``batch(step, worker)`` is stateless: the payload comes
    from ``seeded_generator(seed, step, worker)``."""

    vocab_size: int = 32
    copy_len: int = 8
    delay: int = 8
    batch_size: int = 16
    seed: int = 0
    device: Any = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def seq_len(self):
        return 1 + self.copy_len + self.delay + self.copy_len

    def batch(self, step: int, worker: int = 0):
        """(inputs, targets), each ``(batch_size, seq_len)`` int32 on the
        device: inputs are the marker 1, the payload, then zeros (blanks
        and the answer's slots); targets are -1 (ignored) but for the
        payload at the tail."""
        B, n = self.batch_size, self.copy_len
        payload = torch.randint(2, self.vocab_size, (B, n),
                                generator=seeded_generator(self.seed, step,
                                                           worker),
                                dtype=torch.int32)
        marker = torch.ones((B, 1), dtype=torch.int32)
        inputs = torch.cat([marker, payload, torch.zeros(
            (B, self.delay + n), dtype=torch.int32)], dim=1)
        ignore = torch.full((B, 1 + n + self.delay), -1, dtype=torch.int32)
        targets = torch.cat([ignore, payload], dim=1)
        return inputs.to(self.device), targets.to(self.device)
