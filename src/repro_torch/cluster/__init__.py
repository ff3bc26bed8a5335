"""repro_torch.cluster -- the federated client/coordinator runtime
(PyTorch port of ``repro.cluster``).

Submodules, imported lazily (``core.async_sim`` imports ``cluster.wire``,
and the runtime imports ``core.async_sim``):

* ``wire``        -- packed binary codec + measured byte accounting
* ``transport``   -- in-process hub and TCP sockets, schedulers, faults
* ``coordinator`` -- the parameter-server side of the async loop
* ``client``      -- the worker side
* ``scenarios``   -- federated knobs: plans, participation, Dirichlet shards
* ``subscribe``   -- the serve leg's subscriber cursors and DIFF framing
* ``replica``     -- the inference replica
* ``runner``      -- coordinator + clients (+ replicas) in one process
"""
from __future__ import annotations

import importlib

_SUBMODULES = ("wire", "transport", "coordinator", "client", "scenarios",
               "subscribe", "replica", "runner")

__all__ = list(_SUBMODULES) + ["run_inprocess"]


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name == "run_inprocess":
        return importlib.import_module(".runner", __name__).run_inprocess
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
