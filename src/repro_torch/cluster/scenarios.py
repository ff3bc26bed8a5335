"""Federated scenario knobs the single-process simulator cannot express
(PyTorch port of ``repro.cluster.scenarios``).

* :class:`ClientPlan` — one client's life: when it joins (virtual time),
  how many rounds it runs, its compute speed, link model (bandwidth cap /
  latency / loss), and its per-round participation probability.
* :func:`participates` — seeded, per-(client, round) participation draw:
  partial participation / client sampling without any coordination.
* :func:`dirichlet_class_weights` + :class:`NonIIDClassification` —
  label-skewed (non-IID) data sharding: each client draws labels from its
  own Dirichlet(alpha) class distribution over the shared gaussian-blobs
  task, the standard federated heterogeneity benchmark.  Its batches come
  from a ``torch.Generator`` seeded from ``(seed, step, client)``: not the
  reference's ``jax.random`` draws, so tests that compare the two packages
  feed both the same numpy batches.
* :func:`hetero_plans` — a fleet builder mirroring ``make_schedule``'s
  lognormal speed model, with optional stragglers, late joiners, and early
  leavers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.synthetic import (ClassificationTask,
                                        seeded_generator)

from .transport import FaultPolicy


@dataclasses.dataclass(frozen=True)
class ClientPlan:
    """Everything scenario-specific about one client."""

    client_id: int
    n_rounds: int = 10
    join_time: float = 0.0        # virtual time the client becomes active
    compute_time: float = 1.0     # virtual seconds per local step
    participation: float = 1.0    # per-round participation probability
    bandwidth: float | None = None  # uplink bytes/second (None = infinite)
    delay: float = 0.0            # extra seconds per frame
    drop_prob: float = 0.0        # uplink frame loss probability
    seed: int = 0

    def fault_policy(self, *, realtime: bool = True) -> FaultPolicy:
        return FaultPolicy(bandwidth=self.bandwidth, delay=self.delay,
                           drop_prob=self.drop_prob,
                           seed=(self.seed * 9973 + self.client_id),
                           realtime=realtime)


def participates(plan: ClientPlan, round_idx: int) -> bool:
    """Seeded per-round participation draw — identical on every replay."""
    if plan.participation >= 1.0:
        return True
    rng = np.random.default_rng(
        (plan.seed, plan.client_id, round_idx))
    return bool(rng.random() < plan.participation)


def hetero_plans(
    n_clients: int,
    n_rounds: int,
    *,
    hetero: float = 0.5,
    seed: int = 0,
    participation: float = 1.0,
    late_join: int = 0,
    early_leave: int = 0,
    bandwidth: float | None = None,
    drop_prob: float = 0.0,
) -> list[ClientPlan]:
    """A heterogeneous fleet: lognormal compute speeds (same model as
    ``async_sim.make_schedule``), the last ``late_join`` clients joining
    mid-run and the first ``early_leave`` leaving after half their rounds."""
    rng = np.random.default_rng(seed)
    speeds = np.exp(rng.normal(0.0, hetero, n_clients))
    plans = []
    for c in range(n_clients):
        joins_late = c >= n_clients - late_join
        leaves_early = c < early_leave
        plans.append(ClientPlan(
            client_id=c,
            n_rounds=max(1, n_rounds // 2) if leaves_early else n_rounds,
            join_time=float(n_rounds / 2) if joins_late else 0.0,
            compute_time=float(1.0 / speeds[c]),
            participation=participation,
            bandwidth=bandwidth,
            drop_prob=drop_prob,
            seed=seed,
        ))
    return plans


# ---------------------------------------------------------------------------
# non-IID data sharding
# ---------------------------------------------------------------------------

def dirichlet_class_weights(
    n_clients: int, n_classes: int, alpha: float, *, seed: int = 0,
) -> np.ndarray:
    """(n_clients, n_classes) row-stochastic label distributions.

    Small ``alpha`` concentrates each client on few classes (strong skew);
    ``alpha -> inf`` recovers the IID uniform distribution.
    """
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.full(n_classes, alpha), size=n_clients)
    return w.astype(np.float64)


@dataclasses.dataclass(frozen=True)
class NonIIDClassification:
    """Label-skewed view of :class:`ClassificationTask`.

    Same gaussian-blob geometry and eval set as the IID task — only each
    client's label marginal changes, so accuracy numbers stay comparable.
    """

    task: ClassificationTask
    alpha: float = 0.3
    shard_seed: int = 0
    n_clients: int = 8

    def weights(self) -> np.ndarray:
        # per-instance memo (not lru_cache: that would pin every instance
        # in a module-global cache for the interpreter's lifetime);
        # read-only so a caller can't corrupt later batch() draws
        w = self.__dict__.get("_weights")
        if w is None:
            w = dirichlet_class_weights(self.n_clients, self.task.n_classes,
                                        self.alpha, seed=self.shard_seed)
            w.setflags(write=False)
            object.__setattr__(self, "_weights", w)
        return w

    def batch(self, step: int, client: int):
        """``(x, y)`` of one client's batch on the task's device: labels
        drawn from the client's class distribution, the task's blobs."""
        gen = seeded_generator(self.task.seed, step, client)
        w = torch.from_numpy(np.array(self.weights()[client]))
        y = torch.multinomial(w, self.task.batch_size, replacement=True,
                              generator=gen)
        x = self.task.centers()[y] + self.task.noise * torch.randn(
            (self.task.batch_size, self.task.n_features), generator=gen)
        return x.to(self.task.device), y.to(self.task.device)

    def eval_set(self, n: int = 512):
        return self.task.eval_set(n)
