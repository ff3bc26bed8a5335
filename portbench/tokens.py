"""The benchmark's token traffic: Markov-chain sequences over the
vocabulary, as the program's own synthetic stream makes them (a frozen
copy, so that no change to the program moves the traffic).  A fixed
random transition table gives each token ``branching`` successors; a
sequence starts at a random token and walks the table by random branch
choices.  Every draw comes from ``--seed``: the table from
``numpy.random.default_rng(seed)``, batch ``i``'s start tokens and
branches from a generator seeded with ``(seed, i)``.  The walks of all
batches run together on the host, one vectorised step per position, and
the batches are copied to the device once.
"""
from __future__ import annotations

import numpy as np
import torch


def transition(vocab: int, branching: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, (vocab, branching)).astype(np.int64)


def walks(table: np.ndarray, batch_size: int, seq_len: int, seed: int,
          n: int) -> np.ndarray:
    """Batches ``0..n-1``: ``(n, batch_size, seq_len)`` int32 token ids."""
    vocab, branching = table.shape
    starts, branches = [], []
    for i in range(n):
        rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
        starts.append(rng.integers(0, vocab, batch_size))
        branches.append(rng.integers(0, branching, (batch_size, seq_len - 1)))
    tok = np.concatenate(starts)
    br = np.concatenate(branches)
    out = np.empty((n * batch_size, seq_len), dtype=np.int32)
    out[:, 0] = tok
    for t in range(seq_len - 1):
        tok = table[tok, br[:, t]]
        out[:, t + 1] = tok
    return out.reshape(n, batch_size, seq_len)


def batches(traffic: dict, vocab: int, seed: int, device):
    """The traffic's ``distinct_batches`` batches on ``device``, each
    ``{"tokens": (batch, seq) int32}``."""
    table = transition(vocab, traffic["branching"], seed)
    toks = torch.from_numpy(walks(table, traffic["batch"], traffic["seq"],
                                  seed, traffic["distinct_batches"]))
    toks = toks.to(device)
    return [{"tokens": t} for t in toks.unbind(0)]
