"""Core algorithm: sparsification, engines, SAMomentum, strategies, the
model-difference server, the asynchronous simulator and its scan runner."""
from .baselines import STRATEGIES, make_strategy  # noqa: F401
from .scan_runner import run_async_scan  # noqa: F401
