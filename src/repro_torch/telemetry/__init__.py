"""Flight-recorder telemetry (PyTorch port of ``repro.telemetry``).

* :mod:`repro_torch.telemetry.metrics` -- :class:`MetricsState`: fixed-shape
  counters and log2-bucketed histograms (staleness, up/down nnz, update
  magnitude, per-worker events) as tensors on the run's device, updated
  with no host sync and drained only at eval points and at the end.
* :mod:`repro_torch.telemetry.trace` -- the host-side :class:`Recorder`:
  Chrome trace-event / Perfetto spans (``trace.json``) and a JSONL event
  log (``events.jsonl``); :data:`NULL` is the free no-op default.
* :mod:`repro_torch.telemetry.logs` -- the leveled ``log`` facility.

The contract every runner honours: telemetry OFF is the untouched code
path, telemetry ON changes no data-plane bit.
"""
from . import metrics
from .logs import get_logger, set_level, set_log_file, set_recorder
from .metrics import MetricsState
from .trace import NULL, NullRecorder, Recorder

__all__ = [
    "metrics", "MetricsState",
    "Recorder", "NullRecorder", "NULL",
    "get_logger", "set_level", "set_log_file", "set_recorder",
]
