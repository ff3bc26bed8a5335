"""Core algorithm: sparsification, engines, SAMomentum, strategies, the
model-difference server and the asynchronous simulator."""
from .baselines import STRATEGIES, make_strategy  # noqa: F401
