"""Optimizers and learning-rate schedules (PyTorch port of
``repro.optim``)."""
from .optimizers import (AdamWState, MomentumState, adamw_init, adamw_update,
                         cosine_lr, momentum_init, momentum_update,
                         sgd_update, step_decay_lr)

__all__ = [
    "AdamWState", "MomentumState", "adamw_init", "adamw_update",
    "momentum_init", "momentum_update", "sgd_update", "cosine_lr",
    "step_decay_lr",
]
