"""Host-side flight recorder: Chrome-trace/Perfetto spans + JSONL events
(the port's own copy of ``repro.telemetry.trace``, which imports no JAX).

One :class:`Recorder` per run.  It buffers three things in memory and
writes them out on :meth:`close`:

* **spans** — ``with rec.span("coord/server_batch"): ...`` records a
  complete ("ph": "X") Chrome trace event with microsecond timestamps;
  ``rec.instant(...)`` records an instant ("ph": "i").  The whole buffer
  serializes to ``trace.json`` in the Chrome trace-event format, loadable
  by Perfetto / chrome://tracing.  Spans measure HOST wall-clock between
  enter and exit — for work on the card that is enqueue time (CUDA launches
  are asynchronous); the recorder never inserts device syncs to "fix"
  that.
* **events** — ``rec.event("run_summary", n_events=..., ...)`` appends one
  structured record to ``events.jsonl`` (one JSON object per line, each
  stamped with seconds-since-recorder-start ``t`` and a ``kind``).
* **counters** — ``rec.count("client/3/drops")`` bumps a named counter;
  the full counter map is flushed as a final ``{"kind": "counters"}``
  JSONL record so reports can build per-client tables.

All methods are thread-safe (the cluster runtime records from coordinator
and client threads) and cheap enough to leave in hot host loops; the
module-level :data:`NULL` recorder turns every call into a no-op so
runners can thread one object through unconditionally.
"""
from __future__ import annotations

import json
import os
import pathlib
import threading
import time

TRACE_FILE = "trace.json"
EVENTS_FILE = "events.jsonl"


class _Span:
    """Reusable span context; appends one complete event on exit."""

    __slots__ = ("rec", "name", "cat", "args", "t0")

    def __init__(self, rec, name, cat, args):
        self.rec, self.name, self.cat, self.args = rec, name, cat, args

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.rec._complete(self.name, self.cat, self.t0,
                           time.perf_counter(), self.args)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Recorder:
    """Buffering trace + JSONL recorder for one run."""

    enabled = True

    def __init__(self, run_dir: str | os.PathLike | None = None):
        self.run_dir = pathlib.Path(run_dir) if run_dir is not None else None
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._trace: list[dict] = []
        self._jsonl: list[str] = []
        self.counters: dict[str, float] = {}
        self._lock = threading.Lock()

    # -- spans -------------------------------------------------------------

    def span(self, name: str, cat: str = "run", **args) -> _Span:
        return _Span(self, name, cat, args or None)

    def _complete(self, name, cat, t0, t1, args):
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": round((t0 - self._t0) * 1e6, 3),
              "dur": round((t1 - t0) * 1e6, 3),
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._trace.append(ev)

    def instant(self, name: str, cat: str = "run", **args) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": round((time.perf_counter() - self._t0) * 1e6, 3),
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._trace.append(ev)

    # -- structured events -------------------------------------------------

    def event(self, kind: str, **fields) -> None:
        rec = {"t": round(time.perf_counter() - self._t0, 6), "kind": kind}
        rec.update(fields)
        line = json.dumps(rec, default=str)
        with self._lock:
            self._jsonl.append(line)

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    # -- lifecycle ---------------------------------------------------------

    def flush(self) -> list[str]:
        """Write ``trace.json`` + ``events.jsonl`` under ``run_dir`` (no-op
        without one); returns the paths written."""
        if self.run_dir is None:
            return []
        with self._lock:
            if self.counters:
                rec = {"t": round(time.perf_counter() - self._t0, 6),
                       "kind": "counters", "counters": dict(self.counters)}
                self._jsonl.append(json.dumps(rec))
            trace = list(self._trace)
            lines = list(self._jsonl)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        tpath = self.run_dir / TRACE_FILE
        tpath.write_text(json.dumps(
            {"traceEvents": trace, "displayTimeUnit": "ms"}))
        epath = self.run_dir / EVENTS_FILE
        epath.write_text("".join(line + "\n" for line in lines))
        return [str(tpath), str(epath)]

    def close(self) -> list[str]:
        return self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NullRecorder(Recorder):
    """Every method a no-op; the default recorder threaded through hot
    loops so call sites need no ``if`` guards."""

    enabled = False

    def __init__(self):
        self.run_dir = None
        self.counters = {}

    def span(self, name, cat="run", **args):
        return _NULL_SPAN

    def instant(self, name, cat="run", **args):
        pass

    def event(self, kind, **fields):
        pass

    def count(self, name, n=1):
        pass

    def flush(self):
        return []


NULL = NullRecorder()
