"""Leveled logging for the launchers — the ``print`` replacement (the
port's own copy of ``repro.telemetry.logs``, under its own namespace).

``get_logger("train")`` returns a stdlib logger under the ``repro_torch.``
namespace whose default handler writes BARE messages to stdout — so
``log.info("[train] done")`` is byte-identical to the ``print`` it
replaced and CLI output stays stable by default.  One knob silences or
routes everything:

* ``set_level("warning")`` / ``--log-level`` flag / ``REPRO_LOG`` env var
  — silence INFO chatter fleet-wide.
* ``set_log_file(path)`` / ``--log-file`` flag — mirror every record
  (timestamped + leveled) to a file.
* an active :class:`~repro_torch.telemetry.trace.Recorder` installed via
  :func:`set_recorder` also receives every record as a structured
  ``{"kind": "log"}`` JSONL event.
"""
from __future__ import annotations

import logging
import os
import sys

_ROOT_NAME = "repro_torch"
_configured = False
_active_recorder = None


class _StdoutHandler(logging.StreamHandler):
    """StreamHandler that resolves ``sys.stdout`` at EMIT time, so stream
    redirection after configuration (contextlib.redirect_stdout, pytest's
    capsys) is honored."""

    def __init__(self):
        super().__init__(sys.stdout)

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):
        pass


class _RecorderHandler(logging.Handler):
    """Mirror log records into the active recorder's JSONL event log."""

    def emit(self, record: logging.LogRecord) -> None:
        rec = _active_recorder
        if rec is not None and rec.enabled:
            rec.event("log", level=record.levelname.lower(),
                      logger=record.name.removeprefix(_ROOT_NAME + "."),
                      msg=record.getMessage())


def _configure() -> logging.Logger:
    global _configured
    root = logging.getLogger(_ROOT_NAME)
    if _configured:
        return root
    out = _StdoutHandler()
    out.setFormatter(logging.Formatter("%(message)s"))
    root.addHandler(out)
    root.addHandler(_RecorderHandler())
    root.setLevel(_parse_level(os.environ.get("REPRO_LOG", "info")))
    root.propagate = False
    _configured = True
    return root


def _parse_level(level: str | int) -> int:
    if isinstance(level, int):
        return level
    value = logging.getLevelName(str(level).upper())
    if not isinstance(value, int):
        raise ValueError(f"unknown log level {level!r}")
    return value


def get_logger(name: str = "") -> logging.Logger:
    """A leveled logger; default output is bare messages on stdout."""
    root = _configure()
    return root.getChild(name) if name else root


def set_level(level: str | int) -> None:
    """One flag to silence/route the launchers: 'debug' | 'info' |
    'warning' | 'error' | 'critical' (or a numeric level)."""
    _configure().setLevel(_parse_level(level))


def set_log_file(path: str) -> None:
    """Additionally mirror records (timestamped) to ``path``."""
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    _configure().addHandler(handler)


def set_recorder(recorder) -> None:
    """Route log records into ``recorder``'s JSONL stream (None detaches)."""
    global _active_recorder
    _configure()
    _active_recorder = recorder
